"""Dense stage-0 rejection filter: the stage-0 cascade over every window of a
scan scale.

At stage 0 every window's shape is the mean shape (c/jda.c:361; shift_size
is 0 at detection time), so for a fixed window size the feature pixel
offsets (xr, yr) = trunc((mean + offset) * win) are the same for every
window: a window at grid position (iy, ix) reads img[iy*step + yr,
ix*step + xr].  The whole stage-0 cascade over a scale is then a dense
computation with host-side offset tables (`node_tables`).

`stage0_filter_all_scales` is the entry point for the whole window ladder of
a batch of images (the fused detect path), `scale_filter` for one scan scale
of a batch, `stage0_filter_image` for the whole ladder of one image (the
non-fused detect path).  On a CUDA tensor each launches the hand-written
kernels: `dense0_filter` (csrc/dense0.cu) for the two batch entries,
`dense0_image` (csrc/dense0_image.cu) for one image.  Both are the walk of
csrc/dense0_walk.cuh, two launches per call: a head phase (one thread per
window, the first HEAD_CARTS carts, tables in shared memory) and a survivor
phase (one warp per window still alive, 32 carts per round).  The kernels'
tables (`prepare_image`) depend on the image geometry and the ladder only;
callers keep them with their plan.  On a CPU tensor each entry runs its
plain PyTorch version: `scale_filter_reference`, which follows the JAX
package's `_scale_filter` (phase planes and shifted crops, full cart loop
for every window), scale by scale.

Applicability: single-scale models, on the C-API window ladder (truncated
offsets) and on the C++ path's ladders (rounded offsets, `rounding=True`;
banded canvases, `shift_tables`).  Multi-scale models on the C++ path's
method 0 take `stage0_filter_all_scales_ms`, plain PyTorch on every device
as in the JAX package, where that filter is XLA only.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from jda_tpu_torch.ops import _build
from jda_tpu_torch.ops.resize import cv_fixed_combine, cv_linear_taps_fixed

Tensor = torch.Tensor

# Stage-0 LBF emission: 4 bits per cart (leaf index 0..7 for depth-4
# trees), 8 carts per int32 word, cart k in word k//8 at nibble k%8.  The
# fused survivor tail reads these words instead of re-descending stage 0.
LBF_BITS = 4
LBF_PER_WORD = 32 // LBF_BITS


def lbf_words(K: int) -> int:
    return -(-K // LBF_PER_WORD)


# ---------------------------------------------------------------------------
# Host-side tables
# ---------------------------------------------------------------------------

def node_tables(
    mean_shape_f32: np.ndarray,  # [2L] float32 (must match device dtype)
    stage: Dict[str, np.ndarray],  # host stage-0 params (f32/int32)
    win: int,
    step: int,
    rounding: bool = False,
) -> Dict[str, np.ndarray]:
    """Host-side per-(cart, node, point) crop table for one scan scale.

    Reproduces the reference coordinate arithmetic exactly: float32
    (mean + offset) * win; trunc toward zero (C path, c/jda.c:375-381) or
    round half away from zero (C++ path, data.cpp:48-51); clamp to
    [0, win-1].  Each point (yr, xr) is stored in phase-plane form: plane
    pi = (yr % step) * step + (xr % step) at row u = yr // step, column
    v = xr // step.
    """
    ms_x = mean_shape_f32[0::2].astype(np.float32)
    ms_y = mean_shape_f32[1::2].astype(np.float32)
    w32 = np.float32(win)

    def to_int(v):
        if rounding:
            return np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(
                np.int32
            )
        return v.astype(np.int32)

    def point(lmk, off):
        # lmk [C, 7] int32; off [C, 7, 2] float32
        px = ms_x[lmk] + off[..., 0].astype(np.float32)
        py = ms_y[lmk] + off[..., 1].astype(np.float32)
        xr = np.clip(to_int(px * w32), 0, win - 1)
        yr = np.clip(to_int(py * w32), 0, win - 1)
        pi = (yr % step) * step + (xr % step)
        return pi.astype(np.int32), (yr // step).astype(np.int32), (
            xr // step
        ).astype(np.int32)

    pi1, u1, v1 = point(stage["lmk1"], stage["off1"])
    pi2, u2, v2 = point(stage["lmk2"], stage["off2"])
    return {
        "pi1": pi1, "u1": u1, "v1": v1,
        "pi2": pi2, "u2": u2, "v2": v2,
        "th": stage["feat_th"].astype(np.int32),
        "ls": stage["leaf_scores"].astype(np.float32),
        "mean": stage["mean"].astype(np.float32),
        "std": stage["std"].astype(np.float32),
        "cth": stage["cart_th"].astype(np.float32),
    }


def node_tables_ms(
    mean_shape_f32: np.ndarray,  # [2L] float32
    stage: Dict[str, np.ndarray],  # host stage-0 params incl. "scale"
    win: int,
    step: int,
    sizes: Tuple[int, int, int],  # (img_o_size, img_h_size, img_q_size)
    rounding: bool = True,
) -> Dict[str, np.ndarray]:
    """Multi-scale crop tables for the dense stage-0 filter (C++ method-0
    semantics, cascador.cpp:216-262): every window is a win x win crop of
    the scan level, per-window resized to the o/h/q patch sizes with
    cv::resize INTER_LINEAR, and feature pixels are read from the resized
    patch at clip(to_int((mean + offset) * size_s), 0, size_s - 1).

    Because the resize ratio win -> size_s is fixed, each resized-patch
    pixel is a fixed-point 4-tap combination of window-crop pixels at
    offsets that are constant per (cart, node, point), so each point becomes
    4 phase-plane crops plus OpenCV's exact integer combine
    (ops/resize.cv_fixed_combine).  Origin-scale points degenerate to
    identity taps (size_o == win in the method-0 scan).

    Table layout per point p in {1, 2}: pi{p}/u{p}/v{p} [C, node_n, 4]
    (crop order r0c0, r0c1, r1c0, r1c1), ax0_{p}/ax1_{p}/by0_{p}/by1_{p}
    [C, node_n] int32 (coefficient scale 2^11)."""
    ms_x = mean_shape_f32[0::2].astype(np.float32)
    ms_y = mean_shape_f32[1::2].astype(np.float32)
    scale_arr = np.asarray(stage["scale"], np.int32)  # [C, node_n]
    sizes = tuple(int(s) for s in sizes)
    size_of = np.asarray(sizes, np.int32)[scale_arr]  # [C, node_n]
    msz = max(sizes)
    # padded per-scale tap LUTs [3, msz]
    lut_s0 = np.zeros((3, msz), np.int32)
    lut_s1 = np.zeros((3, msz), np.int32)
    lut_c0 = np.zeros((3, msz), np.int32)
    lut_c1 = np.zeros((3, msz), np.int32)
    for s, sz in enumerate(sizes):
        s0, s1, c0, c1 = cv_linear_taps_fixed(win, sz)
        lut_s0[s, :sz], lut_s1[s, :sz] = s0, s1
        lut_c0[s, :sz], lut_c1[s, :sz] = c0, c1

    def to_int(v):
        if rounding:
            return np.where(v >= 0, np.floor(v + 0.5), np.ceil(v - 0.5)).astype(
                np.int32
            )
        return v.astype(np.int32)

    out: Dict[str, np.ndarray] = {}
    for p, (lmk, off) in enumerate(
        ((stage["lmk1"], stage["off1"]), (stage["lmk2"], stage["off2"])), 1
    ):
        px = ms_x[lmk] + off[..., 0].astype(np.float32)
        py = ms_y[lmk] + off[..., 1].astype(np.float32)
        szf = size_of.astype(np.float32)
        xr = np.clip(to_int(px * szf), 0, size_of - 1)
        yr = np.clip(to_int(py * szf), 0, size_of - 1)
        c0 = lut_s0[scale_arr, xr]
        c1 = lut_s1[scale_arr, xr]
        r0 = lut_s0[scale_arr, yr]
        r1 = lut_s1[scale_arr, yr]
        ys = np.stack([r0, r0, r1, r1], -1)  # [C, node_n, 4] src rows
        xs = np.stack([c0, c1, c0, c1], -1)  # src cols
        out[f"pi{p}"] = ((ys % step) * step + (xs % step)).astype(np.int32)
        out[f"u{p}"] = (ys // step).astype(np.int32)
        out[f"v{p}"] = (xs // step).astype(np.int32)
        out[f"ax0_{p}"] = lut_c0[scale_arr, xr]
        out[f"ax1_{p}"] = lut_c1[scale_arr, xr]
        out[f"by0_{p}"] = lut_c0[scale_arr, yr]
        out[f"by1_{p}"] = lut_c1[scale_arr, yr]
    out.update(
        th=np.asarray(stage["feat_th"], np.int32),
        ls=np.asarray(stage["leaf_scores"], np.float32),
        mean=np.asarray(stage["mean"], np.float32),
        std=np.asarray(stage["std"], np.float32),
        cth=np.asarray(stage["cart_th"], np.float32),
    )
    return out


def shift_tables(
    tab: Dict[str, np.ndarray], y0: int, x0: int, step: int
) -> Dict[str, np.ndarray]:
    """Shift a node table (`node_tables` or `node_tables_ms`) to a
    window-grid origin (y0, x0) on the canvas.

    Both must be multiples of step: window (iy, ix) of the shifted grid
    sits at (y0 + iy*step, x0 + ix*step), and because y0 % step == 0 the
    phase index is unchanged while the plane row/col offsets translate by
    (y0/step, x0/step).  Lets one canvas carry several banded window grids
    (packed method-0 pyramids)."""
    if y0 % step or x0 % step:
        raise ValueError(f"shift_tables: origin {(y0, x0)} off the step {step}")
    out = dict(tab)
    out["u1"] = tab["u1"] + y0 // step
    out["u2"] = tab["u2"] + y0 // step
    out["v1"] = tab["v1"] + x0 // step
    out["v2"] = tab["v2"] + x0 // step
    return out


def pack_tables(tab: Dict[str, np.ndarray], node_n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pack node_tables output into two row tables:
    tabi [K, 6*node_n + node_n]: (pi1,u1,v1,pi2,u2,v2) per node, then th;
    tabf [K, leaf_n + 3]: leaf scores, mean, std, cart_th."""
    K = tab["th"].shape[0]
    ints = np.concatenate(
        [
            np.stack(
                [tab["pi1"], tab["u1"], tab["v1"], tab["pi2"], tab["u2"], tab["v2"]],
                axis=-1,
            ).reshape(K, 6 * node_n),
            tab["th"].reshape(K, node_n),
        ],
        axis=1,
    ).astype(np.int32)
    flts = np.concatenate(
        [
            tab["ls"],
            tab["mean"][:, None],
            tab["std"][:, None],
            tab["cth"][:, None],
        ],
        axis=1,
    ).astype(np.float32)
    return ints, flts


def _pad_noop_carts(tabi: Tensor, tabf: Tensor, leaf_n: int, kpad: int):
    """Append kpad never-rejecting no-op carts (zero leaf scores, mean 0,
    std 1, cart_th -inf, all crop coords 0) to packed tables."""
    if not kpad:
        return tabi, tabf
    tabi = torch.cat([tabi, tabi.new_zeros((kpad, tabi.shape[1]))])
    pad_row = tabf.new_zeros(tabf.shape[1])  # leaf scores + mean
    pad_row[leaf_n + 1] = 1.0  # std
    pad_row[leaf_n + 2] = -float("inf")  # cart_th
    tabf = torch.cat([tabf, pad_row.expand(kpad, -1)])
    return tabi, tabf


def _phase_decompose(img: Tensor, s: int, hp: int = 0, wp: int = 0) -> Tensor:
    """[B, H, W] -> [B, s*s, Hp, Wp] phase planes (Hp >= ceil(H/s)):
    plane a*s+b holds img[a::s, b::s]."""
    B, H, W = img.shape
    Hp = max(-(-H // s), hp)
    Wp = max(-(-W // s), wp)
    pad = torch.nn.functional.pad(img, (0, Wp * s - W, 0, Hp * s - H))
    return (
        pad.reshape(B, Hp, s, Wp, s)
        .permute(0, 2, 4, 1, 3)
        .reshape(B, s * s, Hp, Wp)
    )


# ---------------------------------------------------------------------------
# The filter: plain version, kernel wrapper
# ---------------------------------------------------------------------------

def scale_filter_reference(
    img: Tensor,  # [B, H, W] uint8
    tabi: Tensor,  # [K, 7*node_n] int32 (pack_tables)
    tabf: Tensor,  # [K, leaf_n + 3] float32
    *,
    step: int,
    ny: int,
    nx: int,
    depth: int,
    emit_lbf: bool = False,
):
    """Plain PyTorch version of the filter (the JAX package's
    `_scale_filter`): every cart runs on every window of the grid.

    Pixels are read as shifted crops of int32 phase planes; every node of
    every cart is evaluated and the path bits pick the leaf.  A dead
    window's score stays frozen.  With emit_lbf the carts are padded to a
    whole number of LBF words with no-op carts, which stay out of nvis.

    Returns (score f32, alive bool, nvis i32), each [B, ny, nx], and with
    emit_lbf the packed leaf words i32 [B, ny, nx, lbf_words(K)].
    """
    B = img.shape[0]
    node_n = (1 << (depth - 1)) - 1
    leaf_n = node_n + 1
    K = tabi.shape[0]
    ph = _phase_decompose(img.to(torch.int32), step)
    if emit_lbf:
        tabi, tabf = _pad_noop_carts(tabi, tabf, leaf_n, lbf_words(K) * LBF_PER_WORD - K)
    rows = tabi.tolist()
    th_all = tabi[:, 6 * node_n :].reshape(-1, node_n, 1, 1, 1)

    score = torch.zeros((B, ny, nx), dtype=torch.float32, device=img.device)
    alive = torch.ones((B, ny, nx), dtype=torch.bool, device=img.device)
    nvis = torch.zeros((B, ny, nx), dtype=torch.int32, device=img.device)
    words, word = [], None
    for k, row in enumerate(rows):

        def crop(o):
            pi, u, v = row[o : o + 3]
            return ph[:, pi, u : u + ny, v : v + nx]

        vals = torch.stack(
            [crop(6 * j) - crop(6 * j + 3) for j in range(node_n)]
        )  # [node_n, B, ny, nx]
        bits = (vals > th_all[k]).to(torch.int64)
        node = torch.zeros((1, B, ny, nx), dtype=torch.int64, device=img.device)
        for _ in range(depth - 1):
            node = 2 * node + 1 + bits.gather(0, node)
        leaf = (node[0] - node_n).to(torch.int32)
        b = tabf[k, :leaf_n][leaf.to(torch.int64)]

        s_new = (score + b - tabf[k, leaf_n]) / tabf[k, leaf_n + 1]
        score = torch.where(alive, s_new, score)
        if k < K:
            nvis = nvis + alive.to(torch.int32)
        alive = alive & (score >= tabf[k, leaf_n + 2])
        if emit_lbf:
            v = leaf << (LBF_BITS * (k % LBF_PER_WORD))
            word = v if word is None else word | v
            if k % LBF_PER_WORD == LBF_PER_WORD - 1:
                words.append(word)
                word = None
    if not emit_lbf:
        return score, alive, nvis
    return score, alive, nvis, torch.stack(words, dim=-1)


MS_CART_CHUNK = 16


def scale_filter_ms_reference(
    img: Tensor,  # [B, H, W] uint8
    tab: Dict[str, np.ndarray],  # node_tables_ms (optionally shifted)
    *,
    step: int,
    ny: int,
    nx: int,
    depth: int,
):
    """The multi-scale filter of one scan grid (the JAX package's
    `_scale_filter_ms`), plain PyTorch on the image's device: every cart on
    every window, each node point read as 4 phase-plane crops combined with
    OpenCV's fixed-point arithmetic (`cv_fixed_combine`), then the same
    score chain as `scale_filter_reference`.  The crops of MS_CART_CHUNK
    carts are gathered at once (bounding the gather's memory); the chain
    runs cart by cart.

    Returns (score f32, alive bool, nvis i32), each [B, ny, nx]."""
    B, dev = img.shape[0], img.device
    node_n = (1 << (depth - 1)) - 1
    ph = _phase_decompose(img.to(torch.int32), step)
    _, _, Hp, Wp = ph.shape
    flat = ph.reshape(B, -1)
    grid = (
        torch.arange(ny, device=dev)[:, None] * Wp + torch.arange(nx, device=dev)
    ).reshape(-1)
    t = {k: torch.as_tensor(np.asarray(v), device=dev) for k, v in tab.items()}
    for p in (1, 2):
        t[f"off{p}"] = ((t[f"pi{p}"] * Hp + t[f"u{p}"]) * Wp + t[f"v{p}"]).long()
    reach = max(int(t["off1"].max()), int(t["off2"].max())) + int(grid[-1])
    if reach >= flat.shape[1] or min(int(t["off1"].min()), int(t["off2"].min())) < 0:
        raise ValueError("dense0 ms filter: tables read outside the image")
    K = t["th"].shape[0]
    n = ny * nx
    score = torch.zeros((B, n), dtype=torch.float32, device=dev)
    alive = torch.ones((B, n), dtype=torch.bool, device=dev)
    nvis = torch.zeros((B, n), dtype=torch.int32, device=dev)
    for c0 in range(0, K, MS_CART_CHUNK):
        c1 = min(c0 + MS_CART_CHUNK, K)
        C = c1 - c0

        def pix(p):
            # [B, C, node_n, 4, n] crops -> [B, C, node_n, n] resized pixels
            crops = flat[:, t[f"off{p}"][c0:c1].reshape(-1, 1) + grid].reshape(
                B, C, node_n, 4, n
            )
            ax0 = t[f"ax0_{p}"][c0:c1, :, None]
            ax1 = t[f"ax1_{p}"][c0:c1, :, None]
            t0 = ax0 * crops[:, :, :, 0] + ax1 * crops[:, :, :, 1]
            t1 = ax0 * crops[:, :, :, 2] + ax1 * crops[:, :, :, 3]
            return cv_fixed_combine(
                t0, t1, t[f"by0_{p}"][c0:c1, :, None], t[f"by1_{p}"][c0:c1, :, None]
            )

        bits = (pix(1) - pix(2) > t["th"][c0:c1, :, None]).to(torch.int64)
        node = torch.zeros((B, C, 1, n), dtype=torch.int64, device=dev)
        for _ in range(depth - 1):
            node = 2 * node + 1 + bits.gather(2, node)
        leaf = node[:, :, 0] - node_n  # [B, C, n]
        b = t["ls"][torch.arange(c0, c1, device=dev)[None, :, None], leaf]
        for k in range(C):
            s_new = (score + b[:, k] - t["mean"][c0 + k]) / t["std"][c0 + k]
            score = torch.where(alive, s_new, score)
            nvis = nvis + alive.to(torch.int32)
            alive = alive & (score >= t["cth"][c0 + k])
    return tuple(o.reshape(B, ny, nx) for o in (score, alive, nvis))


def stage0_filter_all_scales_ms(
    img: Tensor,  # [B, H, W] uint8
    tabs: Sequence[Dict[str, np.ndarray]],  # node_tables_ms per scan grid
    *,
    meta: Sequence[Tuple[int, int, int, int]],  # (win, step, ny, nx)
    depth: int,
):
    """Full stage-0 of a multi-scale model over every scan grid of a packed
    method-0 pyramid (the JAX package's `stage0_filter_all_scales_ms`):
    (score [B, n], alive [B, n], nvis [B, n]) flat in window order, grid by
    grid.  Plain PyTorch on the image's device (`scale_filter_ms_reference`);
    the JAX package runs it in XLA, with no Pallas kernel."""
    B = img.shape[0]
    parts = [[], [], []]
    for (_, step, ny, nx), tab in zip(meta, tabs):
        out = scale_filter_ms_reference(img, tab, step=step, ny=ny, nx=nx, depth=depth)
        for i, o in enumerate(out):
            parts[i].append(o.reshape(B, ny * nx))
    return tuple(torch.cat(p, dim=1) for p in parts)


def kernel_nodes(tabi: Tensor, *, step: int, W: int, depth: int) -> Tensor:
    """The kernel's node table from the packed tabi: int32 [K, node_n, 4]
    of (yr1*W + xr1, yr2*W + xr2, th, 0), with (yr, xr) = (u*step + pi //
    step, v*step + pi % step), the truncated and clamped offsets that
    node_tables encoded as phase-plane coordinates."""
    node_n = (1 << (depth - 1)) - 1
    K = tabi.shape[0]
    pts = tabi[:, : 6 * node_n].reshape(K, node_n, 2, 3)
    pi, u, v = pts.unbind(-1)
    off = (u * step + pi // step) * W + v * step + pi % step  # [K, node_n, 2]
    th = tabi[:, 6 * node_n :]
    return torch.stack(
        [off[..., 0], off[..., 1], th, torch.zeros_like(th)], dim=-1
    ).contiguous()


_P, _I = ctypes.c_void_p, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_ARGTYPES = {
    # img, B, H, W, recs, recs_host, S, nodes, tabf, K, depth, n, head, score,
    # alive, nvis, lbf, queue, counters, phases, stream, launched
    "dense0": ("dense0_filter", [_P, _I, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                                 _I, _P, _P, _P, _P, _P, _P, _I, _P, _IP]),
    # img, H, W, recs, recs_host, S, nodes, tabf, K, depth, n, head, score,
    # alive, nvis, queue, counters, phases, stream, launched
    "dense0_image": ("dense0_image", [_P, _I, _I, _P, _P, _I, _P, _P, _I, _I, _I,
                                      _I, _P, _P, _P, _P, _P, _I, _P, _IP]),
}

# Carts of the kernels' head phase (one thread per window, tables in shared
# memory); windows still alive after it go one to a warp.  32 is the measured
# optimum on an H100 (chip_smoke.py phases 6 and 10 time 8, 16, 32 and 64);
# only `launch` and `launch_image` take another.
HEAD_CARTS = 32
PHASE_HEAD, PHASE_SURVIVORS = 1, 2


def _lib(name: str = "dense0") -> ctypes.CDLL:
    lib = _build.load(name)
    if not getattr(lib, "_jda_bound", False):
        fn = getattr(lib, _ARGTYPES[name][0])
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES[name][1]
        lib._jda_bound = True
    return lib


def _max_offsets(tabi: Tensor, step: int, node_n: int) -> Tensor:
    """int32 [2]: the largest row and column offset (yr, xr) that any
    (cart, node, point) of a packed tabi reads inside its window."""
    if not tabi.shape[0]:
        return tabi.new_zeros(2)
    pts = tabi[:, : 6 * node_n].reshape(-1, node_n, 2, 3)
    return torch.stack(
        [
            (pts[..., 1] * step + pts[..., 0] // step).max(),
            (pts[..., 2] * step + pts[..., 0] % step).max(),
        ]
    )


def _check_tables(name: str, tabi: Tensor, tabf: Tensor, depth: int, device) -> None:
    node_n = (1 << (depth - 1)) - 1
    K = tabi.shape[0]
    if (
        tabi.dtype != torch.int32
        or tuple(tabi.shape) != (K, 7 * node_n)
        or not tabi.is_contiguous()
    ):
        raise ValueError(f"{name}: tabi must be contiguous int32 [K, {7 * node_n}]")
    if (
        tabf.dtype != torch.float32
        or tuple(tabf.shape) != (K, node_n + 4)
        or not tabf.is_contiguous()
    ):
        raise ValueError(f"{name}: tabf must be contiguous float32 [K, {node_n + 4}]")
    if tabi.device != device or tabf.device != device:
        raise ValueError(f"{name}: img, tabi and tabf must be on one device")


@dataclasses.dataclass(frozen=True)
class ImageTables:
    """The kernels' tables for one image geometry [H, W] and window ladder
    (prepare_image), on the device.  They do not depend on the batch size:
    `dense0_filter` and `dense0_image` take the same set."""

    H: int
    W: int
    depth: int
    meta: Tuple[Tuple[int, int, int, int], ...]
    n: int  # windows in the ladder
    recs: Tensor  # [S, 4] int32: first window index, nx, step, ny
    recs_host: np.ndarray  # the same on the host, for the launch's grid
    nodes: Tensor  # [S, K, node_n, 4] int32 (kernel_nodes per scale)
    tabf: Tensor  # [K, leaf_n + 3] float32, shared by every scale


def prepare_image(
    tabs: Sequence[Tuple[Tensor, Tensor]],  # (tabi, tabf) per scan scale
    *,
    meta: Sequence[Tuple[int, int, int, int]],  # (win, step, ny, nx) per scale
    depth: int,
    H: int,
    W: int,
    device=None,
    name: str = "dense0_image",
) -> ImageTables:
    """Check the per-scale tables against an [H, W] image and build the
    kernels' tables from them.  The check reads the tables back from the
    device once; callers keep the result with their plan.  `device` is the
    images' device where the caller has it (default: the tables').  Both
    kernels take trees of depth 2 to 5: a leaf index must fit the 4 bits of
    a packed leaf word, and the head's tables its shared memory."""
    meta = tuple(tuple(int(v) for v in m) for m in meta)
    if not 2 <= depth <= LBF_BITS + 1:
        raise ValueError(f"{name}: depth {depth} outside [2, {LBF_BITS + 1}]")
    if len(tabs) != len(meta) or not meta:
        raise ValueError(f"{name}: one (tabi, tabf) per scan scale, at least one")
    node_n = (1 << (depth - 1)) - 1
    device = tabs[0][0].device if device is None else device
    tabf = tabs[0][1]
    K = tabf.shape[0]
    for tabi, tf in tabs:
        _check_tables(name, tabi, tf, depth, device)
        if tabi.shape[0] != K:
            raise ValueError(f"{name}: every scale must have the same K carts")
    same = all(torch.equal(tf, tabf) for _, tf in tabs[1:])
    if not same:
        raise ValueError(f"{name}: tabf must be the same for every scale")
    # every window's reads must stay inside the image
    maxes = torch.stack(
        [_max_offsets(tabi, step, node_n) for (_, step, _, _), (tabi, _) in zip(meta, tabs)]
    ).tolist()
    recs, first = [], 0
    for (win, step, ny, nx), (yr_max, xr_max) in zip(meta, maxes):
        if ny < 1 or nx < 1 or step < 1:
            raise ValueError(f"{name}: empty grid or step at win {win}")
        if (ny - 1) * step + yr_max >= H or (nx - 1) * step + xr_max >= W:
            raise ValueError(
                f"{name}: grid and offsets read outside the image at win {win}"
            )
        recs.append((first, nx, step, ny))
        first += ny * nx
    nodes = torch.stack(
        [
            kernel_nodes(tabi, step=step, W=W, depth=depth)
            for (_, step, _, _), (tabi, _) in zip(meta, tabs)
        ]
    ).contiguous()
    recs_host = np.ascontiguousarray(recs, dtype=np.int32)
    return ImageTables(
        H=H, W=W, depth=depth, meta=meta, n=first,
        recs=torch.as_tensor(recs_host, device=device), recs_host=recs_host,
        nodes=nodes, tabf=tabf,
    )


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _check_images(name: str, img: Tensor, t: ImageTables) -> None:
    """The (uint8, contiguous) images against their prepared tables."""
    if tuple(img.shape[-2:]) != (t.H, t.W) or t.nodes.device != img.device:
        raise ValueError(f"{name}: prepared tables are of another geometry")
    if img.numel() // (t.H * t.W) * t.n >= 2**31:
        raise ValueError(f"{name}: the batch's windows do not fit an int32 index")


def walk_scratch(B: int, t: ImageTables) -> Tuple[Tensor, Tensor]:
    """The kernels' scratch for a batch of B images: the survivor queue
    (one int32 per window, written up to the queue's length only) and the
    two counters (queue length, next ticket)."""
    dev = t.nodes.device
    return (
        torch.empty(B * t.n, dtype=torch.int32, device=dev),
        torch.zeros(2, dtype=torch.int32, device=dev),
    )


def launch(
    img: Tensor,  # [B, H, W] uint8
    t: ImageTables,
    out,  # (score, alive, nvis[, lbf]) of B * t.n windows
    *,
    head_carts: int = HEAD_CARTS,
    phases: int = PHASE_HEAD | PHASE_SURVIVORS,
    scratch: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """Launch `dense0_filter` on the current stream into the outputs `out`,
    with inputs already checked by the wrapper: the head phase, the survivor
    phase or (default) both, two kernels.  `scratch` is a `walk_scratch` to
    reuse; its counters are zeroed here before a head phase.  With the
    survivor phase alone the caller provides the queue, the counters
    (queue length, 0) and the head's state in `out`.  Counts the kernels
    launched and returns the scratch, whose first counter is the queue's
    length once the head has run."""
    B = img.shape[0]
    if scratch is None:
        scratch = walk_scratch(B, t)
    elif phases & PHASE_HEAD:
        scratch[1].zero_()
    launched = ctypes.c_int(0)
    rc = _lib().dense0_filter(
        img.data_ptr(), B, t.H, t.W, t.recs.data_ptr(), t.recs_host.ctypes.data,
        t.recs_host.shape[0], t.nodes.data_ptr(), t.tabf.data_ptr(),
        t.tabf.shape[0], t.depth, t.n, head_carts, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr() if len(out) > 3 else None,
        scratch[0].data_ptr(), scratch[1].data_ptr(), phases,
        torch.cuda.current_stream(img.device).cuda_stream, ctypes.byref(launched),
    )
    if rc != 0:
        raise RuntimeError(f"dense0_filter: launch failed, cudaError {rc}")
    scale_filter.launches += launched.value
    return scratch


def _filter_cuda(img, t: ImageTables, shape, emit_lbf: bool):
    """Allocate the outputs of a batch (`shape` per image) and launch."""
    B, dev = img.shape[0], img.device
    out = (
        torch.empty((B,) + shape, dtype=torch.float32, device=dev),
        torch.empty((B,) + shape, dtype=torch.bool, device=dev),
        torch.empty((B,) + shape, dtype=torch.int32, device=dev),
    )
    if emit_lbf:
        # rows of windows that do not stay alive are never written
        nw = lbf_words(t.tabf.shape[0])
        out += (torch.empty((B,) + shape + (nw,), dtype=torch.int32, device=dev),)
    launch(img, t, out)
    return out


def scale_filter(
    img: Tensor,  # [B, H, W] uint8
    tabi: Tensor,  # [K, 7*node_n] int32 (pack_tables)
    tabf: Tensor,  # [K, leaf_n + 3] float32
    *,
    step: int,
    ny: int,
    nx: int,
    depth: int,
    emit_lbf: bool = False,
):
    """Stage-0 filter of one scan scale: (score, alive, nvis) [B, ny, nx],
    and with emit_lbf the packed leaf words [B, ny, nx, lbf_words(K)].

    On CUDA tensors this launches the `dense0_filter` kernels (built at first
    use) on a ladder of this one scale, and counts them in
    `scale_filter.launches`; the tables are checked and prepared at every
    call, which reads them back once.  On CPU tensors it runs
    `scale_filter_reference`.  Score, alive and nvis are bit-identical
    between the two.  The kernel stops a window at the cart that rejects
    it, so its LBF words are defined only where alive is true.
    """
    if img.device.type == "cpu":
        return scale_filter_reference(
            img, tabi, tabf, step=step, ny=ny, nx=nx, depth=depth,
            emit_lbf=emit_lbf,
        )
    if img.device.type != "cuda":
        raise ValueError(f"dense0_filter: no kernel for device {img.device}")
    if img.dtype != torch.uint8 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError("dense0_filter: img must be a contiguous uint8 [B, H, W]")
    t = prepare_image(
        [(tabi, tabf)], meta=[(0, step, ny, nx)], depth=depth, H=img.shape[1],
        W=img.shape[2], device=img.device, name="dense0_filter",
    )
    _check_images("dense0_filter", img, t)
    return _filter_cuda(img, t, (ny, nx), emit_lbf)


scale_filter.launches = 0


def stage0_filter_all_scales(
    img: Tensor,  # [B, H, W] uint8
    tabs: Sequence[Tuple[Tensor, Tensor]],  # (tabi, tabf) per scan scale
    *,
    meta: Sequence[Tuple[int, int, int, int]],  # (win, step, ny, nx)
    depth: int,
    emit_lbf: bool = False,
    prepared: Optional[ImageTables] = None,
):
    """Full stage-0 over every scan scale of a batch.

    Outputs are flat in the reference's window enumeration order (win outer,
    y middle, x inner — c/jda.c:331-339), so index i is window i of
    detect.enumerate_windows.  Returns (score [B, n], alive [B, n], nvis
    [B, n]) and, with emit_lbf, packed stage-0 leaf words
    [B, n, lbf_words(K)], defined where alive is true.

    On CUDA tensors the whole ladder is one call of `dense0_filter` (two
    kernels, counted in `scale_filter.launches`) that writes the flat
    outputs; `prepared` takes the tables of `prepare_image` for this
    geometry, so that a caller who keeps them with its plan pays their
    check once and a call does not synchronise.  On CPU tensors the plain
    filter runs scale by scale.
    """
    if img.device.type == "cpu":
        B = img.shape[0]
        parts = [[], [], [], []]
        for (_, step, ny, nx), (tabi, tabf) in zip(meta, tabs):
            out = scale_filter_reference(
                img, tabi, tabf, step=step, ny=ny, nx=nx, depth=depth,
                emit_lbf=emit_lbf,
            )
            for i, o in enumerate(out):
                parts[i].append(o.reshape((B, ny * nx) + o.shape[3:]))
        return tuple(torch.cat(p, dim=1) for p in parts if p)
    if img.device.type != "cuda":
        raise ValueError(f"dense0_filter: no kernel for device {img.device}")
    if img.dtype != torch.uint8 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError("dense0_filter: img must be a contiguous uint8 [B, H, W]")
    if prepared is None:
        prepared = prepare_image(
            tabs, meta=meta, depth=depth, H=img.shape[1], W=img.shape[2],
            device=img.device, name="dense0_filter",
        )
    elif prepared.depth != depth or prepared.meta != tuple(tuple(m) for m in meta):
        raise ValueError("dense0_filter: prepared tables are of another geometry")
    _check_images("dense0_filter", img, prepared)
    return _filter_cuda(img, prepared, (prepared.n,), emit_lbf)


# ---------------------------------------------------------------------------
# The whole ladder of one image: plain version, kernel wrapper
# ---------------------------------------------------------------------------

def stage0_filter_image_reference(
    img: Tensor,  # [H, W] uint8
    tabs: Sequence[Tuple[Tensor, Tensor]],
    *,
    meta: Sequence[Tuple[int, int, int, int]],
    depth: int,
):
    """Plain PyTorch version of `stage0_filter_image`: the plain filter on
    img[None], scale by scale, flattened and concatenated in window
    enumeration order."""
    if not meta:
        raise ValueError("dense0_image: one (tabi, tabf) per scan scale, at least one")
    parts = [[], [], []]
    for (_, step, ny, nx), (tabi, tabf) in zip(meta, tabs):
        out = scale_filter_reference(
            img[None], tabi, tabf, step=step, ny=ny, nx=nx, depth=depth
        )
        for i, o in enumerate(out):
            parts[i].append(o.reshape(-1))
    return tuple(torch.cat(p) for p in parts)


def launch_image(
    img: Tensor,
    t: ImageTables,
    out,
    *,
    head_carts: int = HEAD_CARTS,
    phases: int = PHASE_HEAD | PHASE_SURVIVORS,
    scratch: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor]:
    """Launch `dense0_image` on the current stream into the flat outputs
    `out` = (score, alive, nvis), with inputs already checked by the
    wrapper: both kernels (default) or one phase, as `launch` does for
    `dense0_filter`.  `scratch` is a `walk_scratch` of one image to reuse;
    its counters are zeroed here before a head phase.  Counts the kernels
    launched and returns the scratch."""
    if scratch is None:
        scratch = walk_scratch(1, t)
    elif phases & PHASE_HEAD:
        scratch[1].zero_()
    launched = ctypes.c_int(0)
    rc = _lib("dense0_image").dense0_image(
        img.data_ptr(), t.H, t.W, t.recs.data_ptr(), t.recs_host.ctypes.data,
        t.recs_host.shape[0], t.nodes.data_ptr(), t.tabf.data_ptr(),
        t.tabf.shape[0], t.depth, t.n, head_carts, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), scratch[0].data_ptr(),
        scratch[1].data_ptr(), phases,
        torch.cuda.current_stream(img.device).cuda_stream, ctypes.byref(launched),
    )
    if rc != 0:
        raise RuntimeError(f"dense0_image: launch failed, cudaError {rc}")
    stage0_filter_image.launches += launched.value
    return scratch


def stage0_filter_image(
    img: Tensor,  # [H, W] uint8
    tabs: Sequence[Tuple[Tensor, Tensor]],  # (tabi, tabf) per scan scale
    *,
    meta: Sequence[Tuple[int, int, int, int]],  # (win, step, ny, nx) per scale
    depth: int,
    prepared: Optional[ImageTables] = None,
):
    """Stage-0 filter of one image over every scan scale of its ladder:
    flat (score f32, alive bool, nvis i32), each [n], index i being window
    i of detect.enumerate_windows.  No leaf words.

    On a CUDA tensor this is one call of `dense0_image` (built at first use;
    two kernels, the head and the survivor phase, counted in
    `stage0_filter_image.launches`); `prepared` takes the tables of
    `prepare_image` for this geometry, so that a caller who keeps them pays
    their check once.  On a CPU tensor it runs
    `stage0_filter_image_reference`.  The two are bit-identical.
    """
    if img.dim() != 2:
        raise ValueError("dense0_image: img must be one [H, W] image")
    if img.device.type == "cpu":
        return stage0_filter_image_reference(img, tabs, meta=meta, depth=depth)
    if img.device.type != "cuda":
        raise ValueError(f"dense0_image: no kernel for device {img.device}")
    if img.dtype != torch.uint8 or not img.is_contiguous():
        raise ValueError("dense0_image: img must be a contiguous uint8 [H, W]")
    H, W = img.shape
    if prepared is None:
        prepared = prepare_image(
            tabs, meta=meta, depth=depth, H=H, W=W, device=img.device
        )
    elif prepared.depth != depth or prepared.meta != tuple(tuple(m) for m in meta):
        raise ValueError("dense0_image: prepared tables are of another geometry")
    _check_images("dense0_image", img, prepared)
    dev = img.device
    out = (
        torch.empty(prepared.n, dtype=torch.float32, device=dev),
        torch.empty(prepared.n, dtype=torch.bool, device=dev),
        torch.empty(prepared.n, dtype=torch.int32, device=dev),
    )
    launch_image(img, prepared, out)
    return out


stage0_filter_image.launches = 0
