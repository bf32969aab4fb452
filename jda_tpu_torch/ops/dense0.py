"""Dense stage-0 rejection filter: the stage-0 cascade over every window of a
scan scale.

At stage 0 every window's shape is the mean shape (c/jda.c:361; shift_size
is 0 at detection time), so for a fixed window size the feature pixel
offsets (xr, yr) = trunc((mean + offset) * win) are the same for every
window: a window at grid position (iy, ix) reads img[iy*step + yr,
ix*step + xr].  The whole stage-0 cascade over a scale is then a dense
computation with host-side offset tables (`node_tables`).

`scale_filter` is the entry point for one scan scale of a batch of images.
On a CUDA tensor it launches the hand-written kernel `dense0_filter`
(csrc/dense0.cu); on a CPU tensor it runs `scale_filter_reference`, the
plain PyTorch version, which follows the JAX package's `_scale_filter`
(phase planes and shifted crops, full cart loop for every window).

`stage0_filter_image` is the entry point for the whole window ladder of one
image (the non-fused detect path): on a CUDA tensor one launch of
`dense0_image` (csrc/dense0_image.cu) serves every scale; on a CPU tensor
`stage0_filter_image_reference` runs the plain filter scale by scale.

Applicability: single-scale models on the C-API window ladder.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from jda_tpu_torch.ops import _build

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
_ARGTYPES = {
    # img, B, H, W, nodes, tabf, K, depth, step, ny, nx, score, alive, nvis,
    # lbf, stream
    "dense0": ("dense0_filter", [_P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I,
                                 _P, _P, _P, _P, _P]),
    # img, W, recs, S, nodes, tabf, K, depth, n, score, alive, nvis, stream
    "dense0_image": ("dense0_image", [_P, _I, _P, _I, _P, _P, _I, _I, _I,
                                      _P, _P, _P, _P]),
}


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


def _scale_filter_cuda(img, tabi, tabf, *, step, ny, nx, depth, emit_lbf):
    node_n = (1 << (depth - 1)) - 1
    if not 2 <= depth <= LBF_BITS + 1:
        raise ValueError(f"dense0_filter: depth {depth} outside [2, {LBF_BITS + 1}]")
    if img.dtype != torch.uint8 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError("dense0_filter: img must be a contiguous uint8 [B, H, W]")
    K = tabi.shape[0]
    _check_tables("dense0_filter", tabi, tabf, depth, img.device)
    B, H, W = img.shape
    nodes = kernel_nodes(tabi, step=step, W=W, depth=depth)
    # every window's reads must stay inside its own image
    yr_max, xr_max = _max_offsets(tabi, step, node_n).tolist()
    if (ny - 1) * step + yr_max >= H or (nx - 1) * step + xr_max >= W:
        raise ValueError("dense0_filter: grid and offsets read outside the image")
    dev = img.device
    out = (
        torch.empty((B, ny, nx), dtype=torch.float32, device=dev),
        torch.empty((B, ny, nx), dtype=torch.bool, device=dev),
        torch.empty((B, ny, nx), dtype=torch.int32, device=dev),
    )
    if emit_lbf:
        out += (torch.empty((B, ny, nx, lbf_words(K)), dtype=torch.int32, device=dev),)
    launch(img, nodes, tabf, out, step=step, depth=depth)
    return out


def launch(img: Tensor, nodes: Tensor, tabf: Tensor, out, *, step: int, depth: int) -> None:
    """Launch `dense0_filter` on the current stream into the outputs `out`
    = (score, alive, nvis[, lbf]), with inputs already checked by the
    wrapper (`nodes` from kernel_nodes).  Counts the launch."""
    B, H, W = img.shape
    _, ny, nx = out[0].shape
    rc = _lib().dense0_filter(
        img.data_ptr(), B, H, W, nodes.data_ptr(), tabf.data_ptr(),
        tabf.shape[0], depth, step, ny, nx, out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(),
        out[3].data_ptr() if len(out) > 3 else None,
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dense0_filter: launch failed, cudaError {rc}")
    scale_filter.launches += 1


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

    On CUDA tensors this launches the `dense0_filter` kernel (built at first
    use) and counts the launch in `scale_filter.launches`; on CPU tensors it
    runs `scale_filter_reference`.  Score, alive and nvis are bit-identical
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
    return _scale_filter_cuda(
        img, tabi, tabf, step=step, ny=ny, nx=nx, depth=depth, emit_lbf=emit_lbf
    )


scale_filter.launches = 0


def stage0_filter_all_scales(
    img: Tensor,  # [B, H, W] uint8
    tabs: Sequence[Tuple[Tensor, Tensor]],  # (tabi, tabf) per scan scale
    *,
    meta: Sequence[Tuple[int, int, int, int]],  # (win, step, ny, nx)
    depth: int,
    emit_lbf: bool = False,
):
    """Full stage-0 over every scan scale.

    Outputs are flattened per scale and concatenated in the reference's
    window enumeration order (win outer, y middle, x inner — c/jda.c:331-339),
    so index i is window i of detect.enumerate_windows.  Returns
    (score [B, n], alive [B, n], nvis [B, n]) and, with emit_lbf, packed
    stage-0 leaf words [B, n, lbf_words(K)].
    """
    B = img.shape[0]
    parts = [[], [], [], []]
    for (_, step, ny, nx), (tabi, tabf) in zip(meta, tabs):
        out = scale_filter(
            img, tabi, tabf, step=step, ny=ny, nx=nx, depth=depth,
            emit_lbf=emit_lbf,
        )
        for i, o in enumerate(out):
            parts[i].append(o.reshape((B, ny * nx) + o.shape[3:]))
    return tuple(torch.cat(p, dim=1) for p in parts if p)


# ---------------------------------------------------------------------------
# The whole ladder of one image: plain version, kernel wrapper
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ImageTables:
    """The tables of `dense0_image` for one image geometry and ladder,
    on the device (prepare_image)."""

    H: int
    W: int
    depth: int
    meta: Tuple[Tuple[int, int, int, int], ...]
    n: int  # windows in the ladder
    recs: Tensor  # [S, 4] int32: first window index, nx, step, ny
    nodes: Tensor  # [S, K, node_n, 4] int32 (kernel_nodes per scale)
    tabf: Tensor  # [K, leaf_n + 3] float32, shared by every scale


def prepare_image(
    tabs: Sequence[Tuple[Tensor, Tensor]],  # (tabi, tabf) per scan scale
    *,
    meta: Sequence[Tuple[int, int, int, int]],  # (win, step, ny, nx) per scale
    depth: int,
    H: int,
    W: int,
) -> ImageTables:
    """Check the per-scale tables against an [H, W] image and build the
    kernel's tables from them.  The check reads the tables back from the
    device once; callers keep the result with their plan."""
    name = "dense0_image"
    meta = tuple(tuple(int(v) for v in m) for m in meta)
    if not 2 <= depth <= 30:
        raise ValueError(f"{name}: depth {depth} outside [2, 30]")
    if len(tabs) != len(meta) or not meta:
        raise ValueError(f"{name}: one (tabi, tabf) per scan scale, at least one")
    node_n = (1 << (depth - 1)) - 1
    device = tabs[0][0].device
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
    if first >= 2**31:
        raise ValueError(f"{name}: {first} windows do not fit an int32 index")
    nodes = torch.stack(
        [
            kernel_nodes(tabi, step=step, W=W, depth=depth)
            for (_, step, _, _), (tabi, _) in zip(meta, tabs)
        ]
    ).contiguous()
    return ImageTables(
        H=H, W=W, depth=depth, meta=meta, n=first,
        recs=torch.tensor(recs, dtype=torch.int32, device=device),
        nodes=nodes, tabf=tabf,
    )


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


def launch_image(img: Tensor, t: ImageTables, out) -> None:
    """Launch `dense0_image` on the current stream into the flat outputs
    `out` = (score, alive, nvis), with inputs already checked by the
    wrapper.  Counts the launch."""
    rc = _lib("dense0_image").dense0_image(
        img.data_ptr(), t.W, t.recs.data_ptr(), t.recs.shape[0],
        t.nodes.data_ptr(), t.tabf.data_ptr(), t.tabf.shape[0], t.depth, t.n,
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        torch.cuda.current_stream(img.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"dense0_image: launch failed, cudaError {rc}")
    stage0_filter_image.launches += 1


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

    On a CUDA tensor this is one launch of the `dense0_image` kernel (built
    at first use), counted in `stage0_filter_image.launches`; `prepared`
    takes the tables of `prepare_image` for this geometry, so that a caller
    who keeps them pays their check once.  On a CPU tensor it runs
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
        prepared = prepare_image(tabs, meta=meta, depth=depth, H=H, W=W)
    elif (
        (prepared.H, prepared.W, prepared.depth) != (H, W, depth)
        or prepared.meta != tuple(tuple(m) for m in meta)
        or prepared.nodes.device != img.device
    ):
        raise ValueError("dense0_image: prepared tables are of another geometry")
    dev = img.device
    out = (
        torch.empty(prepared.n, dtype=torch.float32, device=dev),
        torch.empty(prepared.n, dtype=torch.bool, device=dev),
        torch.empty(prepared.n, dtype=torch.int32, device=dev),
    )
    launch_image(img, prepared, out)
    return out


stage0_filter_image.launches = 0
