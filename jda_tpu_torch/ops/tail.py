"""The cascade's survivor tail as one CUDA kernel.

`walk` launches `tail_walk` (csrc/tail.cu): a queue of windows walks stages
0..T-1 of the cascade in one launch, one warp per lane, where the plain tail
(ops/cascade.py: `carts_descend`, `score_chain`, `apply_regression`)
launches kernels per cart and per op.  Two callers:

  * ops/fused.run_fused: every stage-0 survivor of a gather group, where the
    tensors are on CUDA and T >= 2; the dense filter's result starts each
    lane (`score0`, `nvis0`, the leaf words).
  * detect.Detector's non-fused path for multi-scale models on CUDA with
    T >= 1: every window of one image's ladder (`sel` None), stage 0's
    chain from cart 0 (`score0` None), each node reading the o/h/q level
    it names from the image's stacked pyramid (`levels`).  The kernel's
    multi-scale instantiation does the level reads; single-scale models
    run the other one.

The kernel replaces no TPU kernel: the JAX package's tail is XLA.  The
plain functions stay as its counterpart, bit-equal, and serve the CPU and
the paths the kernel does not take (T == 1 models, `_run_batch`'s other
callers, `cascade_full`, training).  `walk` raises on the CPU.  The tables
(`pack_tables`) depend on the model alone: a caller keeps them.  The
library is built at its first load together with `dense0`
(ops/_build.py), one nvcc each, in parallel.

Tracing: the span `tail` (`B`, the batch's images) around the checks and
the launch; the counters `tail_kernel.launches`, `tail_kernel.lanes`
(lanes queued) and `tail_kernel.ms_lanes` (lanes queued to the
multi-scale walk).  On the kernel path the spans `stage`, `descend`,
`score_chain` and `regression` do not open and `tail.lane_carts` is not
counted: the kernel does that work in one launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from jda_tpu_torch import tracing
from jda_tpu_torch.ops import _build
from jda_tpu_torch.ops import dense0 as D0

Tensor = torch.Tensor

ROUND = 32  # carts a warp descends at once: a split point lies on a round's end


@dataclasses.dataclass(frozen=True)
class TailTables:
    """The model's tables in the kernel's layout (pack_tables)."""

    T: int
    K: int
    depth: int
    L2: int
    nodes_i: Tensor  # [T, K, node_n, 4] int32: lmk1, lmk2, feat_th, level (o/h/q 0/1/2)
    nodes_f: Tensor  # [T, K, node_n, 4] float32: off1 (x, y), off2 (x, y)
    cartf: Tensor  # [T, K, leaf_n + 3] float32: leaf scores, mean, std, cart_th
    W: Tensor  # [T, K * leaf_n, L2] float32
    mean_shape: Tensor  # [L2] float32


def pack_tables(dev: Dict[str, Tensor], depth: int) -> TailTables:
    """The kernel's tables from a model's device tensors
    (CascadeParams.device_tensors, float32).  Checks that every landmark
    index lies inside the shape and every node's level is o, h or q,
    which reads them back once."""
    T, K, node_n = dev["lmk1"].shape
    leaf_n = dev["leaf_scores"].shape[-1]
    if node_n != (1 << (depth - 1)) - 1 or leaf_n != node_n + 1:
        raise ValueError(f"tail_walk: tables are not of depth {depth}")
    L2 = dev["mean_shape"].shape[-1]
    lmk = torch.stack([dev["lmk1"], dev["lmk2"]], dim=-1)
    ok = torch.stack([((lmk >= 0) & (2 * lmk < L2)).all(),
                      ((dev["scale"] >= 0) & (dev["scale"] <= 2)).all()]).tolist()
    if not ok[0]:
        raise ValueError("tail_walk: a landmark index lies outside the shape")
    if not ok[1]:
        raise ValueError("tail_walk: a node's level is not o, h or q (0, 1, 2)")
    f32 = torch.float32
    return TailTables(
        T=T, K=K, depth=depth, L2=L2,
        nodes_i=torch.stack(
            [dev["lmk1"], dev["lmk2"], dev["feat_th"], dev["scale"]],
            dim=-1,
        ).to(torch.int32).contiguous(),
        nodes_f=torch.cat([dev["off1"], dev["off2"]], dim=-1).to(f32).contiguous(),
        cartf=torch.cat(
            [dev["leaf_scores"], dev["mean"][..., None], dev["std"][..., None],
             dev["cart_th"][..., None]],
            dim=-1,
        ).to(f32).contiguous(),
        W=dev["W"].to(f32).contiguous(),
        mean_shape=dev["mean_shape"].to(f32).contiguous(),
    )


def n_points(T: int, split: int) -> int:
    """Compaction points of the plain gather pass after its stage-0 one:
    after the first `split` carts of each stage >= 1 (split > 0), and after
    each stage but the last."""
    return (T - 1) * (split > 0) + max(T - 2, 0)


_P, _I = ctypes.c_void_p, ctypes.c_int
# img, H, W, n, xywin, sel, N, score0, nvis0, lbf, lbase, so, sh, sq, nodes_i,
# nodes_f, cartf, wts, mean_shape, T, K, depth, L2, split, rounding, score,
# nvis, alive, shape, reach, nvis_img, counters, stream, launched
_ARGTYPES = [_P, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
             _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
             ctypes.POINTER(ctypes.c_int)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("tail")
    if not getattr(lib, "_jda_bound", False):
        lib.tail_walk.restype = ctypes.c_int
        lib.tail_walk.argtypes = _ARGTYPES
        lib._jda_bound = True
    return lib


def _check(name: str, t: Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"tail_walk: {name} must be a contiguous {dtype} {list(shape)}")
    if t.device != device:
        raise ValueError(f"tail_walk: {name} is not on the images' device")


def _ptr(t: Optional[Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def walk(
    tabs: TailTables,
    imgs: Tensor,  # [B, H, W] uint8; with `levels` [B, F], one stacked pyramid a row
    xywin: Tensor,  # [n, 3] int32 window (x, y, win)
    sel: Optional[Tensor],  # [N] int64 flat window id b*n + w of each lane, or None: all B*n
    score0: Optional[Tensor],  # [B, n] float32 dense filter score, or None: stage 0's chain
    nvis0: Optional[Tensor],  # [B, n] int32 dense filter visits (None with score0)
    lbf: Optional[Tensor],  # [B, n, lbf_words(K)] int32 stage-0 leaf words, or None
    nvis_img: Optional[Tensor],  # [B] int32: each lane's visits beyond nvis0 added in place
    *,
    rounding: bool,
    split: int,
    levels: Optional[Tuple[Tensor, Tuple[int, int, int]]] = None,
) -> Tuple[Dict[str, Tensor], Tensor]:
    """Walk every lane through stages 0..T-1 on the current stream.

    Returns per lane `score`, `nvis`, `alive`, `shape` [N, L2] and `reach`
    (the compaction points it passed alive, of n_points(T, split)), and the
    device counters [1 + n_points]: the queue's ticket, then the lanes alive
    at each compaction point.  With `score0` the lanes are stage-0
    survivors, and stage 0's leaves come from `lbf` or, without it, a
    descent; without `score0` (and `nvis0`, `lbf`) stage 0 runs its chain
    from score 0 like every later stage.  `levels` = (base [n, 3] int32,
    the o/h/q row strides) runs the multi-scale walk: a node of level l
    reads imgs[b, base[w, l] + y * strides[l] + x] (detect.window_geometry),
    the int32 minimum at or past the row's end.  Does not synchronise."""
    B = imgs.shape[0]
    with tracing.span("tail", B=B):
        if imgs.dtype != torch.uint8 or imgs.dim() != (2 if levels else 3) or (
                not imgs.is_contiguous()):
            raise ValueError("tail_walk: imgs must be a contiguous uint8 "
                             + ("[B, F] of pyramids" if levels else "[B, H, W]"))
        dev = imgs.device
        T, K, L2 = tabs.T, tabs.K, tabs.L2
        n = xywin.shape[0]
        N = B * n if sel is None else sel.shape[0]
        node_n = (1 << (tabs.depth - 1)) - 1
        _check("xywin", xywin, torch.int32, (n, 3), dev)
        if sel is not None:
            _check("sel", sel, torch.int64, (N,), dev)
        if (score0 is None) != (nvis0 is None) or (lbf is not None and score0 is None):
            raise ValueError("tail_walk: nvis0 and lbf go with score0")
        if score0 is not None:
            _check("score0", score0, torch.float32, (B, n), dev)
            _check("nvis0", nvis0, torch.int32, (B, n), dev)
        if lbf is not None:
            _check("lbf", lbf, torch.int32, (B, n, D0.lbf_words(K)), dev)
        if nvis_img is not None:
            _check("nvis_img", nvis_img, torch.int32, (B,), dev)
        strides = (0, 0, 0)
        if levels is not None:
            base, strides = levels[0], tuple(int(s) for s in levels[1])
            _check("base", base, torch.int32, (n, 3), dev)
            if len(strides) != 3 or min(strides) < 1:
                raise ValueError(f"tail_walk: level strides {strides} are not three widths")
        _check("nodes_i", tabs.nodes_i, torch.int32, (T, K, node_n, 4), dev)
        _check("nodes_f", tabs.nodes_f, torch.float32, (T, K, node_n, 4), dev)
        _check("cartf", tabs.cartf, torch.float32, (T, K, node_n + 4), dev)
        _check("W", tabs.W, torch.float32, (T, K * (node_n + 1), L2), dev)
        _check("mean_shape", tabs.mean_shape, torch.float32, (L2,), dev)
        if score0 is not None and T < 2:
            raise ValueError("tail_walk: after the dense filter the kernel walks stages "
                             "1..T-1, T must be >= 2")
        if T < 1:
            raise ValueError("tail_walk: the kernel walks stages 0..T-1, T must be >= 1")
        if split and (split % ROUND or not 0 < split < K):
            raise ValueError(f"tail_walk: split {split} is not a multiple of {ROUND} below K")
        if B * n >= 2**31 or N >= 2**31:
            raise ValueError("tail_walk: the batch's windows do not fit an int32 index")
        if dev.type != "cuda":
            raise ValueError(f"tail_walk: no kernel for device {dev}")
        out = {
            "score": torch.empty(N, dtype=torch.float32, device=dev),
            "nvis": torch.empty(N, dtype=torch.int32, device=dev),
            "alive": torch.empty(N, dtype=torch.bool, device=dev),
            "shape": torch.empty((N, L2), dtype=torch.float32, device=dev),
            "reach": torch.empty(N, dtype=torch.int32, device=dev),
        }
        counters = torch.zeros(1 + n_points(T, split), dtype=torch.int32, device=dev)
        launched = ctypes.c_int(0)
        H, W = (1, imgs.shape[1]) if levels else imgs.shape[1:]
        rc = _lib().tail_walk(
            imgs.data_ptr(), H, W, n, xywin.data_ptr(), _ptr(sel), N, _ptr(score0),
            _ptr(nvis0), _ptr(lbf), None if levels is None else base.data_ptr(),
            *strides, tabs.nodes_i.data_ptr(), tabs.nodes_f.data_ptr(),
            tabs.cartf.data_ptr(), tabs.W.data_ptr(), tabs.mean_shape.data_ptr(), T, K,
            tabs.depth, L2, split, int(rounding), out["score"].data_ptr(),
            out["nvis"].data_ptr(), out["alive"].data_ptr(), out["shape"].data_ptr(),
            out["reach"].data_ptr(), _ptr(nvis_img), counters.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched),
        )
        if rc != 0:
            raise RuntimeError(f"tail_walk: launch failed, cudaError {rc}")
        tracing.count("tail_kernel.launches", launched.value)
        tracing.count("tail_kernel.lanes", N)
        if levels is not None:
            tracing.count("tail_kernel.ms_lanes", N)
        return out, counters
