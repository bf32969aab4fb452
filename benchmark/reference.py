"""The plain reference detector that decides `correct`.

Plain PyTorch and numpy, written from the published semantics and not from
the program: it imports nothing of jda_tpu_torch and takes nothing the
program made.  It runs the cascade of a single-scale model (every node
reads the origin image) over every window of a ladder:

  * C API (`jdaDetect`, native/jda_native.c and the reference's c/jda.c):
    windows from 24 px growing by `scale` (float32), step int(0.1 * win);
    feature coordinates (shape + offset) * win truncated toward zero and
    clamped to the window; final threshold `th`; greedy NMS at 0.3 in
    score order (the C library's exchange sort), output in candidate order;
    landmarks relocated in float32;
  * C++ `jda fddb` method 1 (JoinCascador::Detect, detectMultiScale1):
    windows from `fddb_minimum_size` growing by int(win * factor) at a
    fixed step; coordinates rounded half away from zero (std::round); no
    final threshold; the multimap NMS in score order; landmarks relocated
    in float64; the DetectionStatistic of each image.

Per cart: the node path (2 node + 1 + (pixel difference > threshold)),
score = (score + leaf - mean) / std, rejection when score < threshold; per
stage: the K weight rows of the leaves added to the shape one after
another.  All arithmetic is in `dtype`, float32 as the model states, or
bfloat16 for the control.  The trees of one stage read only the shape the
stage started from, so the reference descends a run of carts at once and
keeps the score chain sequential; stage 0, where every window starts from
the mean shape, reads its feature offsets from per-scale tables.

Besides the answers it counts the work: per image the windows, the cart
visits of stage 0 and of the whole cascade, the windows alive after stage
0 and the windows that finish each stage.

It is the harness's default reference: `answers` and `counted_ops` are the
interface that a configuration's own reference module (the configuration's
`reference` key, benchmark/harness.py) exports in its place.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

STAGE0_RUN = 8  # carts descended together between compactions in stage 0
STAGE0_WINDOWS = 3 << 20  # windows per pass of stage 0 (its leaves take K bytes each)
TAIL_SLAB = 1 << 16  # windows per pass of stages 1..T-1


# ---------------------------------------------------------------------------
# window ladders
# ---------------------------------------------------------------------------

def c_api_ladder(H, W, scale, min_size, max_size) -> List[Tuple[int, int, int, int]]:
    """(win, step, ny, nx) per scan scale of jdaDetect on an H x W image."""
    min_size = max(min_size, 24)
    if max_size <= 0:
        max_size = min(W, H)
    max_size = min(max_size, W, H)
    s32 = np.float32(scale)
    win = 24
    while win < min_size:
        win = int(np.float32(win) * s32)
    out = []
    while win <= max_size:
        step = max(int(np.float32(win) * np.float32(0.1)), 1)
        out.append((win, step, (H - win) // step + 1, (W - win) // step + 1))
        win = int(np.float32(win) * s32)
    return out


def cpp_m1_ladder(H, W, min_size, step, factor) -> List[Tuple[int, int, int, int]]:
    """(win, step, ny, nx) per scan scale of detectMultiScale1."""
    out = []
    win = min_size
    while win <= W and win <= H:
        out.append((win, step, (H - win) // step + 1, (W - win) // step + 1))
        win = int(win * factor)
    return out


def ladder_windows(ladder):
    """x, y, win, scale id of every window, in scan order (scale, row,
    column), as int64 numpy arrays."""
    xs, ys, ws, ss = [], [], [], []
    for s, (win, step, ny, nx) in enumerate(ladder):
        gy, gx = np.meshgrid(np.arange(ny) * step, np.arange(nx) * step, indexing="ij")
        xs.append(gx.reshape(-1))
        ys.append(gy.reshape(-1))
        ws.append(np.full(ny * nx, win))
        ss.append(np.full(ny * nx, s))
    return tuple(np.concatenate(a).astype(np.int64) for a in (xs, ys, ws, ss))


# ---------------------------------------------------------------------------
# the cascade
# ---------------------------------------------------------------------------

def _std_round(v: torch.Tensor) -> torch.Tensor:
    """std::round: half away from zero, exactly (v - trunc(v) is exact)."""
    t = torch.trunc(v)
    up = (v - t).abs() >= 0.5
    return (t + torch.where(up, torch.sign(v), torch.zeros_like(v))).to(torch.int64)


def _to_int(v: torch.Tensor, rounding: bool) -> torch.Tensor:
    return _std_round(v) if rounding else torch.trunc(v).to(torch.int64)


class Cascade:
    """A single-scale model's fields on `device` in `dtype`."""

    def __init__(self, m: dict, device, dtype=torch.float32):
        if np.any(np.asarray(m["scale"]) != 0):
            raise ValueError("the reference serves single-scale models only")
        self.device, self.dtype = torch.device(device), dtype
        self.T, self.K = int(m["T"]), int(m["K"])
        self.depth = int(m["tree_depth"])
        self.node_n = (1 << (self.depth - 1)) - 1
        self.L2 = 2 * int(m["landmark_n"])

        def f(a):
            return torch.as_tensor(np.asarray(a, np.float64)).to(device=self.device, dtype=dtype)

        def i(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=self.device)

        self.mean_shape = f(m["mean_shape"])
        self.lmk1, self.lmk2, self.feat_th = i(m["lmk1"]), i(m["lmk2"]), i(m["feat_th"])
        self.off1, self.off2 = f(m["off1"]), f(m["off2"])
        self.leaf_scores = f(m["leaf_scores"])
        self.cart_th, self.mean, self.std = f(m["cart_th"]), f(m["mean"]), f(m["std"])
        self.W = f(m["W"]).reshape(self.T, self.K, -1, self.L2)

    def point(self, shape_x, shape_y, off, win, rounding):
        """The (dx, dy) of a feature point inside a window of size `win`:
        (shape + offset) * win to an integer, clamped to [0, win - 1]."""
        wf = win.to(self.dtype)
        x = _to_int((shape_x + off[..., 0]) * wf, rounding)
        y = _to_int((shape_y + off[..., 1]) * wf, rounding)
        hi = win - 1
        return torch.minimum(x.clamp(min=0), hi), torch.minimum(y.clamp(min=0), hi)


def _score_chain(c: Cascade, t, k0, leaves, score, alive, nvis):
    """Carts k0.. of stage t in order: score = (score + leaf - mean) / std
    for the alive windows, a visit each, then rejection below the cart's
    threshold."""
    ls = c.leaf_scores[t]
    for j in range(leaves.shape[1]):
        k = k0 + j
        s_new = (score + ls[k][leaves[:, j]] - c.mean[t, k]) / c.std[t, k]
        score = torch.where(alive, s_new, score)
        nvis = nvis + alive.to(torch.int64)
        alive = alive & (score >= c.cart_th[t, k])
    return score, alive, nvis


def _regress(c: Cascade, t, shape, leaves):
    """shape + the K weight rows of the stage's leaves, one after another."""
    for k in range(c.K):
        shape = shape + c.W[t, k][leaves[:, k]]
    return shape


def _stage0(c: Cascade, flat, base, sidx, tabs):
    """Stage 0 from the mean shape over windows (base pixel, scale id).
    Returns every window's cart visits, and the survivors' indices, scores
    and leaves [m, K]."""
    n = base.shape[0]
    dev = flat.device
    score = torch.zeros(n, dtype=c.dtype, device=dev)
    nvis = torch.zeros(n, dtype=torch.int64, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    out_nvis = torch.zeros(n, dtype=torch.int64, device=dev)
    leaves_all = torch.zeros((n, c.K), dtype=torch.uint8, device=dev)
    o1, o2 = tabs  # [S, K, node_n] flat pixel offsets of the two points
    cur = torch.arange(n, device=dev)
    for k0 in range(0, c.K, STAGE0_RUN):
        k1 = min(k0 + STAGE0_RUN, c.K)
        ks = torch.arange(k0, k1, device=dev)[None, :]
        b = base[cur][:, None]
        s = sidx[cur][:, None]
        node = torch.zeros((cur.shape[0], k1 - k0), dtype=torch.int64, device=dev)
        for _ in range(c.depth - 1):
            p1 = flat[b + o1[s, ks, node]].to(torch.int64)
            p2 = flat[b + o2[s, ks, node]].to(torch.int64)
            node = 2 * node + 1 + (p1 - p2 > c.feat_th[0][ks, node]).to(torch.int64)
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


def _stage0_tables(c: Cascade, ladder, W, rounding):
    """Per scale, cart and node: the flat pixel offset (dy * W + dx) of both
    feature points from the mean shape."""
    dev = c.device
    win = torch.tensor([w for w, _, _, _ in ladder], device=dev)[:, None, None]
    ms_x, ms_y = c.mean_shape[0::2], c.mean_shape[1::2]
    tabs = []
    for lmk, off in ((c.lmk1[0], c.off1[0]), (c.lmk2[0], c.off2[0])):
        x, y = c.point(ms_x[lmk][None], ms_y[lmk][None], off[None], win, rounding)
        tabs.append(y * W + x)
    return tabs


def _tail_stage(c: Cascade, t, flat, base, win, shape, score, nvis, rounding, W):
    """Stage t >= 1 of the windows alive at its start: every cart descends
    from the stage-entry shape, the score chain runs in order, and the
    survivors' shapes take the stage's regression."""
    m = base.shape[0]
    dev = flat.device
    ks = torch.arange(c.K, device=dev)[None, :]
    sx, sy = shape[:, 0::2], shape[:, 1::2]
    wv = win[:, None]
    b = base[:, None]
    node = torch.zeros((m, c.K), dtype=torch.int64, device=dev)
    for _ in range(c.depth - 1):
        pix = []
        for lmk, off in ((c.lmk1[t], c.off1[t]), (c.lmk2[t], c.off2[t])):
            li = lmk[ks, node]
            x, y = c.point(sx.gather(1, li), sy.gather(1, li), off[ks, node], wv, rounding)
            pix.append(flat[b + y * W + x].to(torch.int64))
        node = 2 * node + 1 + (pix[0] - pix[1] > c.feat_th[t][ks, node]).to(torch.int64)
    leaves = node - c.node_n
    alive = torch.ones(m, dtype=torch.bool, device=dev)
    score, alive, nvis = _score_chain(c, t, 0, leaves, score, alive, nvis)
    return alive, score, nvis, _regress(c, t, shape, leaves)


def run_cascade(c: Cascade, imgs: np.ndarray, ladder, rounding: bool):
    """The cascade over every window of `ladder` on each of `imgs` ([B, H,
    W] uint8).  Returns per image a dict: `idx` of the windows alive after
    the last stage (scan order), their `score` and `shape` (window frame),
    and the counts `windows`, `visits0` (stage-0 cart visits), `visits`
    (all cart visits), `alive0` (alive after stage 0), `reject_visits`
    (visits of the windows rejected), `finish` (windows finishing each
    stage)."""
    B, H, W = imgs.shape
    dev = c.device
    x, y, win, sidx = ladder_windows(ladder)
    n = len(x)
    tabs = _stage0_tables(c, ladder, W, rounding)
    win_t = torch.as_tensor(win, device=dev)
    sidx_t = torch.as_tensor(sidx, device=dev)
    off_t = torch.as_tensor(y * W + x, device=dev)
    per = [dict(windows=n, finish=[0] * c.T) for _ in range(B)]
    chunk = max(1, STAGE0_WINDOWS // n)
    # stage 0, a chunk of images at a time; survivors pooled for the tail
    surv_img, surv_win, surv_leaves, surv_score, surv_nvis, flats = [], [], [], [], [], []
    for i0 in range(0, B, chunk):
        i1 = min(i0 + chunk, B)
        flat = torch.as_tensor(np.ascontiguousarray(imgs[i0:i1])).to(dev).reshape(-1)
        flats.append(flat)
        bimg = torch.arange(i1 - i0, device=dev).repeat_interleave(n)
        base = bimg * (H * W) + off_t.repeat(i1 - i0)
        nvis, cur, score, leaves = _stage0(c, flat, base, sidx_t.repeat(i1 - i0), tabs)
        alive = torch.zeros_like(nvis, dtype=torch.bool)
        alive[cur] = True
        v0 = nvis.reshape(i1 - i0, n).sum(1).cpu().numpy()
        a0 = alive.reshape(i1 - i0, n).sum(1).cpu().numpy()
        rej = torch.where(alive, 0, nvis).reshape(i1 - i0, n).sum(1).cpu().numpy()
        for j in range(i1 - i0):
            p = per[i0 + j]
            p["visits0"], p["alive0"] = int(v0[j]), int(a0[j])
            p["visits"], p["reject_visits"] = int(v0[j]), int(rej[j])
            p["finish"][0] = int(a0[j])
        surv_img.append(cur // n + i0)
        surv_win.append(cur % n)
        surv_leaves.append(leaves)
        surv_score.append(score)
        surv_nvis.append(nvis[cur])
    img_i = torch.cat(surv_img)
    win_i = torch.cat(surv_win)
    score = torch.cat(surv_score)
    nvis = torch.cat(surv_nvis)
    shape = _regress(c, 0, c.mean_shape.expand(img_i.shape[0], c.L2).clone(), torch.cat(surv_leaves))
    flat = torch.cat(flats)
    base = img_i * (H * W) + off_t[win_i]
    wsz = win_t[win_i]
    for t in range(1, c.T):
        parts = []
        for s0 in range(0, img_i.shape[0], TAIL_SLAB):
            sl = slice(s0, s0 + TAIL_SLAB)
            parts.append(_tail_stage(c, t, flat, base[sl], wsz[sl], shape[sl], score[sl],
                                     nvis[sl], rounding, W))
        if parts:
            alive, score_t, nvis_t, shape_t = (torch.cat(p) for p in zip(*parts))
        else:
            alive, score_t, nvis_t, shape_t = (
                torch.zeros(0, dtype=torch.bool, device=dev), score, nvis, shape)
        inc = (nvis_t - nvis).cpu().numpy()
        ii = img_i.cpu().numpy()
        rej = np.where(alive.cpu().numpy(), 0, nvis_t.cpu().numpy())
        np_alive = alive.cpu().numpy()
        for j, p in enumerate(per):
            m = ii == j
            p["visits"] += int(inc[m].sum())
            p["reject_visits"] += int(rej[m].sum())
            p["finish"][t] = int(np_alive[m].sum())
        img_i, win_i, base, wsz = img_i[alive], win_i[alive], base[alive], wsz[alive]
        score, nvis, shape = score_t[alive], nvis_t[alive], shape_t[alive]
    ii = img_i.cpu().numpy()
    wi = win_i.cpu().numpy()
    sc = score.float().cpu().numpy()
    sh = shape.float().cpu().numpy()
    for j, p in enumerate(per):
        m = ii == j
        order = np.argsort(wi[m], kind="stable")
        p["idx"] = wi[m][order]
        p["score"] = sc[m][order]
        p["shape"] = sh[m][order]
    return per, (x, y, win)


# ---------------------------------------------------------------------------
# NMS and the answers
# ---------------------------------------------------------------------------

def nms_c(boxes: np.ndarray, scores: np.ndarray, overlap: float = 0.3) -> np.ndarray:
    """The C library's NMS: candidates ordered by score with its exchange
    sort, each kept box removes the later ones whose float32 IoU exceeds
    0.3f; the kept indices in candidate order."""
    n = len(scores)
    if len(np.unique(scores)) == n:
        order = np.argsort(-scores, kind="stable")
    else:  # ties: the exchange sort's own order
        order = list(range(n))
        for i in range(n - 1):
            for j in range(i + 1, n):
                if scores[order[i]] < scores[order[j]]:
                    order[i], order[j] = order[j], order[i]
        order = np.asarray(order, np.int64)
    keep = np.ones(n, bool)
    x, y, sz = (boxes[:, i].astype(np.int64) for i in range(3))
    area = sz * sz
    for i in range(n - 1):
        a = order[i]
        if not keep[a]:
            continue
        b = order[i + 1 :]
        b = b[keep[b]]
        w = np.maximum(np.minimum(x[a] + sz[a], x[b] + sz[b]) - np.maximum(x[a], x[b]), 0)
        h = np.maximum(np.minimum(y[a] + sz[a], y[b] + sz[b]) - np.maximum(y[a], y[b]), 0)
        ov = (w * h).astype(np.float32) / (area[a] + area[b] - w * h).astype(np.float32)
        keep[b[ov > np.float32(overlap)]] = False
    return np.flatnonzero(keep)


def nms_cpp(rects: np.ndarray, scores: np.ndarray, overlap: float = 0.3) -> np.ndarray:
    """JoinCascador's NMS: a multimap from score to index (equal scores in
    insertion order); the last entry is picked, then every entry whose
    float64 IoU with it exceeds `overlap` is erased, itself included; the
    picks in order."""
    order = np.argsort(scores, kind="stable")
    x, y, w, h = (rects[:, i].astype(np.float64) for i in range(4))
    area = rects[:, 2].astype(np.int64) * rects[:, 3].astype(np.int64)
    picked = []
    while order.size:
        last = order[-1]
        picked.append(last)
        ww = np.maximum(0.0, np.minimum(x[order] + w[order], x[last] + w[last])
                        - np.maximum(x[order], x[last]))
        hh = np.maximum(0.0, np.minimum(y[order] + h[order], y[last] + h[last])
                        - np.maximum(y[order], y[last]))
        with np.errstate(divide="ignore", invalid="ignore"):
            ov = ww * hh / (area[order] + area[last] - ww * hh)
        order = order[~(ov > overlap)]
    return np.asarray(picked, np.int64)


def c_api_answers(per, xyw, th, overlap=0.3):
    """jdaDetect's answer of each image: (boxes [n, 3] int32 (x, y, size),
    scores [n] float32, shapes [n, 2L] float32 in image coordinates)."""
    x, y, win = xyw
    out = []
    for p in per:
        m = p["score"] >= np.float32(th)
        idx, sc, sh = p["idx"][m], p["score"][m], p["shape"][m]
        boxes = np.stack([x[idx], y[idx], win[idx]], 1).astype(np.int32)
        k = nms_c(boxes, sc, overlap)
        boxes, sc, sh = boxes[k], sc[k], sh[k].copy()
        sz = boxes[:, 2:3].astype(np.float32)
        sh[:, 0::2] = sh[:, 0::2] * sz + boxes[:, 0:1].astype(np.float32)
        sh[:, 1::2] = sh[:, 1::2] * sz + boxes[:, 1:2].astype(np.float32)
        out.append((boxes, sc, sh))
    return out


def cpp_answers(per, xyw, overlap=0.3):
    """JoinCascador::Detect's answer of each image: (rects [n, 4] int32,
    scores [n] float64, shapes [n, 2L] float64 in image coordinates, the
    DetectionStatistic (patch_n, face_patch_n, nonface_patch_n,
    cart_gothrough_n))."""
    x, y, win = xyw
    out = []
    for p in per:
        idx = p["idx"]
        rects = np.stack([x[idx], y[idx], win[idx], win[idx]], 1).astype(np.int32)
        k = nms_cpp(rects, p["score"].astype(np.float64), overlap)
        rects = rects[k]
        sh = p["shape"][k].astype(np.float64)
        sh[:, 0::2] = rects[:, 0:1] + sh[:, 0::2] * rects[:, 2:3]
        sh[:, 1::2] = rects[:, 1:2] + sh[:, 1::2] * rects[:, 3:4]
        n = p["windows"]
        stat = (n, len(idx), n - len(idx), p["reject_visits"])
        out.append((rects, p["score"][k].astype(np.float64), sh, stat))
    return out


# ---------------------------------------------------------------------------
# the interface the harness calls
# ---------------------------------------------------------------------------

def answers(config: dict, traffic: dict, fields: dict, pool: np.ndarray, device, dtype=None):
    """The reference's answers and counts for every pool image of the
    configuration's entry: (answers, one per image as the program's call
    returns them; per, run_cascade's dict of each image; the ladder)."""
    c = Cascade(fields, device, torch.float32 if dtype is None else dtype)
    H, W = pool.shape[1:]
    if config["entry"] == "c_api":
        k = config["detect"]
        ladder = c_api_ladder(H, W, k["scale"], k["min_size"], k["max_size"])
        rounding = bool(config.get("detector", {}).get("rounding", False))
        per, xyw = run_cascade(c, pool, ladder, rounding=rounding)
        out = [a + (None,) for a in c_api_answers(per, xyw, k["th"], k["nms_overlap"])]
    else:
        f = config["fddb"]
        if f["method"] != 1:
            raise ValueError("the reference runs fddb method 1 only")
        ladder = cpp_m1_ladder(H, W, f["minimum_size"], f["step"], f["scale"])
        per, xyw = run_cascade(c, pool, ladder, rounding=True)
        out = cpp_answers(per, xyw, f["overlap"])
    return out, per, ladder


def counted_ops(p: dict, config: dict) -> int:
    """Operations the cascade needs on one image: per cart visit (depth-1)
    node steps of subtract, compare and two index operations, then add,
    subtract, divide and compare in the score chain; per window finishing
    a stage, K additions of a 2L weight row."""
    depth, K, L2 = config["tree_depth"], config["K"], 2 * config["landmark_n"]
    return p["visits"] * ((depth - 1) * 4 + 4) + sum(p["finish"]) * K * L2
