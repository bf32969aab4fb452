"""The plain reference of a multi-scale model, which decides `correct` for
a configuration that names it (`reference`, benchmark/harness.py).

Plain PyTorch and numpy, written from the published semantics of the C
API (`jdaDetect`, luoyetx/JDA c/jda.c) and not from the program: it
imports nothing of jda_tpu_torch and takes nothing the program made.  It
differs from benchmark/reference.py only in where a point is read:

  * the o/h/q pyramid of each image, built once (c/jda.c:450-457): o the
    image, h resized to (int(W * r), int(H * r)) with r = 1 / sqrtf(2) in
    float32, q resized to (W / 2, H / 2), both from o by the C library's
    bilinear resize (c/jda.c:203-230: ratio (src - 1) / dst, source index
    truncated, weights and sum in float32 in its order, result truncated);
  * each window's patch on every level (c/jda.c:340-354): at (x, y) on o,
    at (int(x * r), int(y * r)) on h, at (x / 2, y / 2) on q, each win x
    win pixels with its level's row stride;
  * each node reads both of its points on the level the node names, at
    the coordinates the single-scale reference computes (shape + offset)
    * win, truncated and clamped to the window, and compares their
    difference with the node's threshold in int32.

The one departure from c/jda.c: the h and q patches claim win x win pixels
of smaller images, so near the bottom edge their reads run past their
level's buffer, where the C library reads whatever memory follows.  Here
the three levels lie end to end in one buffer (o, h, q), a read past a
level's end reads the next level, and a read past the buffer's end gives
the int32 minimum, whose pixel difference wraps in int32: a defined value
where the C library's is undefined.

Every stage runs on every window, with no dense shortcut: stage 0 from the
mean shape a run of carts at a time (its point offsets from per-scale
tables), compacting between runs; stages 1..T-1 on the survivors.  The
score chain and the regression keep the C library's float32 operation
order (benchmark/reference.py's `_score_chain` and `_regress`).  All
arithmetic is in `dtype`: float32 as the model states, or bfloat16 for the
control.  `answers` and `counted_ops` are the harness's interface; `per`
holds no `visits0` or `alive0`, since no dense filter's bound applies to
a path without one.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from benchmark.reference import (Cascade, _regress, _score_chain, c_api_answers,
                                 c_api_ladder, counted_ops, ladder_windows)

__all__ = ["answers", "counted_ops"]  # the harness's interface

FILL = -(1 << 31)  # a read past the pyramid's end
STAGE0_RUN = 8  # carts descended together between compactions in stage 0
STAGE0_WINDOWS = 3 << 20  # windows per pass of stage 0
TAIL_SLAB = 1 << 16  # windows per pass of stages 1..T-1


def _r32() -> np.float32:
    """1.f / sqrtf(2.f)."""
    return np.float32(1.0) / np.sqrt(np.float32(2.0))


def _resize(imgs: torch.Tensor, w: int, h: int, dtype) -> torch.Tensor:
    """The C library's bilinear resize of [B, H, W] uint8 to [B, h, w]."""
    _, src_h, src_w = imgs.shape
    dev = imgs.device

    def ratio(src, dst):
        # a true division: by a Python number, CUDA multiplies by its reciprocal
        return (torch.tensor(src - 1, dtype=dtype, device=dev)
                / torch.tensor(dst, dtype=dtype, device=dev))

    xr, yr = ratio(src_w, w), ratio(src_h, h)
    xf = xr * torch.arange(w, device=dev).to(dtype)
    yf = yr * torch.arange(h, device=dev).to(dtype)
    # the clamps change nothing in float32, where xr * j < src_w - 1; they
    # keep bfloat16's rounded ratios inside the image
    x = torch.trunc(xf).long().clamp(max=src_w - 2)
    y = torch.trunc(yf).long().clamp(max=src_h - 2)
    dx = (xf - x.to(dtype))[None, None, :]
    dy = (yf - y.to(dtype))[None, :, None]
    f = imgs.to(dtype)
    r0, r1 = f[:, y], f[:, y + 1]
    one = torch.ones((), dtype=dtype, device=dev)
    v = (r0[:, :, x] * (one - dx) * (one - dy) + r0[:, :, x + 1] * dx * (one - dy)
         + r1[:, :, x] * (one - dx) * dy + r1[:, :, x + 1] * dx * dy)
    # the cast truncates; the clamp only matters in bfloat16, whose sum can round past 255
    return torch.trunc(v).clamp(0, 255).to(torch.uint8)


def pyramid(imgs: torch.Tensor, dtype):
    """The o/h/q levels of [B, H, W] uint8 images, end to end per image:
    (flat [B, n] uint8, offsets [3], strides [3], as int64 numpy)."""
    _, H, W = imgs.shape
    r = _r32()
    hw, hh = int(np.float32(W) * r), int(np.float32(H) * r)
    levels = [imgs, _resize(imgs, hw, hh, dtype), _resize(imgs, W // 2, H // 2, dtype)]
    sizes = np.array([lv.shape[1] * lv.shape[2] for lv in levels], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    strides = np.array([lv.shape[2] for lv in levels], np.int64)
    return torch.cat([lv.reshape(lv.shape[0], -1) for lv in levels], 1), offsets, strides


def patch_bases(x, y, offsets, strides) -> np.ndarray:
    """[n, 3] flat offset of each window's patch on o, h and q."""
    r = _r32()
    hx = (x.astype(np.float32) * r).astype(np.int64)
    hy = (y.astype(np.float32) * r).astype(np.int64)
    return np.stack([offsets[0] + y * strides[0] + x,
                     offsets[1] + hy * strides[1] + hx,
                     offsets[2] + (y // 2) * strides[2] + x // 2], 1)


class LevelCascade(Cascade):
    """A multi-scale model's fields: the single-scale reference's, plus
    each node's level [T, K, node_n]."""

    def __init__(self, m: dict, device, dtype=torch.float32):
        super().__init__(dict(m, scale=np.zeros_like(m["scale"])), device, dtype)
        self.level = torch.as_tensor(np.asarray(m["scale"], np.int64), device=self.device)


def _read(flat, n, img, at):
    """Pixels at image-local flat offsets `at` of images `img` (one flat
    buffer of n bytes each), as int64; FILL past the buffer's end."""
    v = flat[img * n + at.clamp(max=n - 1)].to(torch.int64)
    return torch.where(at < n, v, FILL)


def _bit(p1, p2, th):
    """The node's test: the int32 pixel difference (wrapped) > th."""
    d = torch.remainder(p1 - p2 + (1 << 31), 1 << 32) - (1 << 31)
    return (d > th).to(torch.int64)


def _stage0_tables(c: LevelCascade, ladder, strides, rounding):
    """Per scale, cart and node: each point's offset inside its level's
    patch (dy * stride + dx) from the mean shape."""
    dev = c.device
    win = torch.tensor([w for w, _, _, _ in ladder], device=dev)[:, None, None]
    stride = torch.as_tensor(strides, device=dev)[c.level[0]][None]
    ms_x, ms_y = c.mean_shape[0::2], c.mean_shape[1::2]
    tabs = []
    for lmk, off in ((c.lmk1[0], c.off1[0]), (c.lmk2[0], c.off2[0])):
        x, y = c.point(ms_x[lmk][None], ms_y[lmk][None], off[None], win, rounding)
        tabs.append(y * stride + x)
    return tabs


def _stage0(c: LevelCascade, flat, n, img, bases, sidx, tabs):
    """Stage 0 from the mean shape over windows (image, patch bases, scale
    id).  Returns every window's cart visits, and the survivors' indices,
    scores and leaves [m, K]."""
    m = img.shape[0]
    dev = flat.device
    score = torch.zeros(m, dtype=c.dtype, device=dev)
    nvis = torch.zeros(m, dtype=torch.int64, device=dev)
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    out_nvis = torch.zeros(m, dtype=torch.int64, device=dev)
    leaves_all = torch.zeros((m, c.K), dtype=torch.uint8, device=dev)
    o1, o2 = tabs
    cur = torch.arange(m, device=dev)
    for k0 in range(0, c.K, STAGE0_RUN):
        k1 = min(k0 + STAGE0_RUN, c.K)
        ks = torch.arange(k0, k1, device=dev)[None, :]
        b, im, s = bases[cur], img[cur][:, None], sidx[cur][:, None]
        node = torch.zeros((cur.shape[0], k1 - k0), dtype=torch.int64, device=dev)
        for _ in range(c.depth - 1):
            at = b.gather(1, c.level[0][ks, node])
            p1 = _read(flat, n, im, at + o1[s, ks, node])
            p2 = _read(flat, n, im, at + o2[s, ks, node])
            node = 2 * node + 1 + _bit(p1, p2, c.feat_th[0][ks, node])
        leaves = node - c.node_n
        leaves_all[cur, k0:k1] = leaves.to(torch.uint8)
        score, alive, nvis = _score_chain(c, 0, k0, leaves, score, alive, nvis)
        out_nvis[cur[~alive]] = nvis[~alive]
        cur, score, nvis = cur[alive], score[alive], nvis[alive]
        alive = alive[alive]
        if cur.shape[0] == 0:
            break
    out_nvis[cur] = nvis
    return out_nvis, cur, score, leaves_all[cur].to(torch.int64)


def _tail_stage(c: LevelCascade, t, flat, n, img, bases, win, shape, score, nvis, strides,
                rounding):
    """Stage t >= 1 of the windows alive at its start: every cart descends
    from the stage-entry shape, reading each node's level, the score chain
    runs in order, and the survivors' shapes take the stage's regression."""
    m = img.shape[0]
    dev = flat.device
    ks = torch.arange(c.K, device=dev)[None, :]
    sx, sy = shape[:, 0::2], shape[:, 1::2]
    wv, im = win[:, None], img[:, None]
    node = torch.zeros((m, c.K), dtype=torch.int64, device=dev)
    for _ in range(c.depth - 1):
        lv = c.level[t][ks, node]
        at, stride = bases.gather(1, lv), strides[lv]
        pix = []
        for lmk, off in ((c.lmk1[t], c.off1[t]), (c.lmk2[t], c.off2[t])):
            li = lmk[ks, node]
            x, y = c.point(sx.gather(1, li), sy.gather(1, li), off[ks, node], wv, rounding)
            pix.append(_read(flat, n, im, at + y * stride + x))
        node = 2 * node + 1 + _bit(pix[0], pix[1], c.feat_th[t][ks, node])
    leaves = node - c.node_n
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    score, alive, nvis = _score_chain(c, t, 0, leaves, score, alive, nvis)
    return alive, score, nvis, _regress(c, t, shape, leaves)


def run_cascade_ms(c: LevelCascade, imgs: np.ndarray, ladder, rounding: bool = False):
    """The multi-scale cascade over every window of `ladder` on each of
    `imgs` ([B, H, W] uint8).  Returns per image a dict: `idx` of the
    windows alive after the last stage (scan order), their `score` and
    `shape` (window frame), and the counts `windows`, `visits` (all cart
    visits) and `finish` (windows finishing each stage)."""
    B = imgs.shape[0]
    dev = c.device
    flat, offsets, strides = pyramid(torch.as_tensor(np.ascontiguousarray(imgs)).to(dev),
                                     c.dtype)
    n_flat = flat.shape[1]
    flat = flat.reshape(-1)
    x, y, win, sidx = ladder_windows(ladder)
    n = len(x)
    tabs = _stage0_tables(c, ladder, strides, rounding)
    strides_t = torch.as_tensor(strides, device=dev)
    bases_t = torch.as_tensor(patch_bases(x, y, offsets, strides), device=dev)
    win_t = torch.as_tensor(win, device=dev)
    sidx_t = torch.as_tensor(sidx, device=dev)
    per: List[dict] = [dict(windows=n, finish=[0] * c.T) for _ in range(B)]
    chunk = max(1, STAGE0_WINDOWS // n)
    parts = []  # stage-0 survivors of each chunk of images
    for i0 in range(0, B, chunk):
        i1 = min(i0 + chunk, B)
        img = torch.arange(i0, i1, device=dev).repeat_interleave(n)
        nvis, cur, score, leaves = _stage0(c, flat, n_flat, img, bases_t.repeat(i1 - i0, 1),
                                           sidx_t.repeat(i1 - i0), tabs)
        v0 = nvis.reshape(i1 - i0, n).sum(1).cpu().numpy()
        a0 = torch.bincount(cur // n, minlength=i1 - i0).cpu().numpy()
        for j in range(i1 - i0):
            per[i0 + j]["visits"] = int(v0[j])
            per[i0 + j]["finish"][0] = int(a0[j])
        parts.append((cur // n + i0, cur % n, leaves, score, nvis[cur]))
    img_i, win_i, leaves, score, nvis = (torch.cat(p) for p in zip(*parts))
    shape = _regress(c, 0, c.mean_shape.expand(img_i.shape[0], c.L2).clone(), leaves)
    for t in range(1, c.T):
        out = []
        for s0 in range(0, img_i.shape[0], TAIL_SLAB):
            sl = slice(s0, s0 + TAIL_SLAB)
            out.append(_tail_stage(c, t, flat, n_flat, img_i[sl], bases_t[win_i[sl]],
                                   win_t[win_i[sl]], shape[sl], score[sl], nvis[sl],
                                   strides_t, rounding))
        if not out:
            break
        alive, score_t, nvis_t, shape_t = (torch.cat(p) for p in zip(*out))
        inc = torch.bincount(img_i, weights=(nvis_t - nvis).double(), minlength=B).cpu()
        fin = torch.bincount(img_i[alive], minlength=B).cpu()
        for j, p in enumerate(per):
            p["visits"] += int(inc[j])
            p["finish"][t] = int(fin[j])
        img_i, win_i = img_i[alive], win_i[alive]
        score, nvis, shape = score_t[alive], nvis_t[alive], shape_t[alive]
    ii, wi = img_i.cpu().numpy(), win_i.cpu().numpy()
    sc, sh = score.float().cpu().numpy(), shape.float().cpu().numpy()
    for j, p in enumerate(per):
        m = ii == j
        order = np.argsort(wi[m], kind="stable")
        p["idx"], p["score"], p["shape"] = wi[m][order], sc[m][order], sh[m][order]
    return per, (x, y, win)


def answers(config: dict, traffic: dict, fields: dict, pool: np.ndarray, device, dtype=None):
    """jdaDetect's answers and counts for every pool image: (answers, one
    per image as the program's call returns them; per, run_cascade_ms's
    dict of each image; the ladder)."""
    if config["entry"] != "c_api":
        raise ValueError("the multi-scale reference serves the C API only")
    # no product here runs on tensor cores, but none may: float32 means float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = LevelCascade(fields, device, torch.float32 if dtype is None else dtype)
    H, W = pool.shape[1:]
    k = config["detect"]
    ladder = c_api_ladder(H, W, k["scale"], k["min_size"], k["max_size"])
    rounding = bool(config.get("detector", {}).get("rounding", False))
    per, xyw = run_cascade_ms(c, pool, ladder, rounding)
    out = [a + (None,) for a in c_api_answers(per, xyw, k["th"], k["nms_overlap"])]
    return out, per, ladder
