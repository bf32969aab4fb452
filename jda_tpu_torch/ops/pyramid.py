"""The multi-scale detector's o/h/q pyramid, built where the image is.

A multi-scale model reads three levels of each image (c/jda.c:443-457):
o, the image; h, its bilinear resize to (int(w/sqrt2), int(h/sqrt2)); q,
its resize to (w//2, h//2).  The non-fused path keeps them stacked in one
flat uint8 buffer of exactly F = H*W + hh*hw + qh*qw bytes, in the layout
of `ops/resize.stack_pyramid(ops/resize.pyramid_c(gray))`: the survivor
tail kernel's level walk reads them there, and a read at or past F gives
the int32 minimum, so the buffer is never padded.

`layout(H, W)` gives that buffer's length, offsets and strides, and the
resize ratios, from the image size alone.  `fill_levels(flat, layout)`
writes h and q into a buffer whose first H*W bytes hold o: on a CUDA
tensor one launch of `pyramid_levels` (csrc/pyramid.cu), on a CPU tensor
its plain PyTorch twin `fill_levels_reference` (`Detector._pyramid` is the
whole step for an image: the upload of o, then `fill_levels`).  Every
output pixel follows `resize_bilinear_c` bit for bit: the ratio
(src - 1) / dst in float32
(computed here, on the host, in numpy: CUDA divides by a Python number as
a multiply by its reciprocal, which rounds the C library's q ratio 479/240
differently), the truncated source index, the float32 weights and the
blend's products and sums in the C library's order, truncated to uint8.

The kernel replaces no TPU kernel: the JAX package builds the pyramid on
the host in numpy.  Tracing: the counter `pyramid_kernel.launches`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from jda_tpu_torch import tracing
from jda_tpu_torch.ops import _build

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Layout:
    """The stacked o/h/q buffer of an H x W image."""

    H: int
    W: int
    F: int  # bytes of the stacked levels
    offsets: np.ndarray  # [3] int32, as stack_pyramid gives them
    strides: np.ndarray  # [3] int32: each level's width
    dims: Tuple[Tuple[int, int], ...]  # (rows, cols) of o, h, q
    ratios: Tuple[Tuple[np.float32, np.float32], ...]  # (x, y) of h, q


def _ratio(src: int, dst: int) -> np.float32:
    # an empty level reads nothing: its ratio is never used
    return np.float32(src - 1) / np.float32(dst) if dst else np.float32(0)


def layout(H: int, W: int) -> Layout:
    """The buffer of `stack_pyramid(pyramid_c(gray))` for a [H, W] image,
    with pyramid_c's level sizes and resize_bilinear_c's ratios."""
    r = np.float32(1.0) / np.float32(math.sqrt(2.0))
    hh, hw = int(np.float32(H) * r), int(np.float32(W) * r)
    qh, qw = H // 2, W // 2
    dims = ((H, W), (hh, hw), (qh, qw))
    sizes = [h * w for h, w in dims]
    offsets = np.array([0, sizes[0], sizes[0] + sizes[1]], np.int32)
    strides = np.array([W, hw, qw], np.int32)
    ratios = tuple((_ratio(W, w), _ratio(H, h)) for h, w in dims[1:])
    return Layout(H, W, sum(sizes), offsets, strides, dims, ratios)


def _resize_reference(o: Tensor, rows: int, cols: int, xr, yr) -> Tensor:
    """resize_bilinear_c of the [H, W] uint8 tensor `o` to rows x cols, in
    plain PyTorch on its device."""
    W, dev = o.shape[1], o.device
    f32 = torch.float32
    xf = torch.tensor(xr, dtype=f32, device=dev) * torch.arange(cols, dtype=f32, device=dev)
    yf = torch.tensor(yr, dtype=f32, device=dev) * torch.arange(rows, dtype=f32, device=dev)
    x, y = xf.to(torch.int32), yf.to(torch.int32)  # truncation
    xd = (xf - x.to(f32))[None, :]
    yd = (yf - y.to(f32))[:, None]
    at = (y.long() * W)[:, None] + x.long()[None, :]
    src = o.reshape(-1)
    a, b = src[at].to(f32), src[at + 1].to(f32)
    c, d = src[at + W].to(f32), src[at + W + 1].to(f32)
    one = torch.ones((), dtype=f32, device=dev)
    v = a * (one - xd) * (one - yd) + b * xd * (one - yd) + c * (one - xd) * yd + d * xd * yd
    return v.to(torch.uint8)  # truncation


def fill_levels_reference(flat: Tensor, lay: Layout) -> None:
    """The plain twin of the kernel: h and q from o, written in place, on
    `flat`'s device (`fill_levels` takes it for CPU tensors; on a card it
    is the kernel's yardstick)."""
    o = flat[: lay.H * lay.W].view(lay.H, lay.W)
    for lvl in (1, 2):
        (rows, cols), (xr, yr) = lay.dims[lvl], lay.ratios[lvl - 1]
        start = int(lay.offsets[lvl])
        flat[start : start + rows * cols] = _resize_reference(o, rows, cols, xr, yr).reshape(-1)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# buf, H, W, hh, hw, qh, qw, hx, hy, qx, qy, stream, launched
_ARGTYPES = [_P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P, ctypes.POINTER(ctypes.c_int)]


def _lib() -> ctypes.CDLL:
    lib = _build.load("pyramid")
    if not getattr(lib, "_jda_bound", False):
        lib.pyramid_levels.restype = ctypes.c_int
        lib.pyramid_levels.argtypes = _ARGTYPES
        lib._jda_bound = True
    return lib


def fill_levels(flat: Tensor, lay: Layout) -> None:
    """Write the h and q levels of the image held in the first H*W bytes
    of `flat`, a contiguous uint8 buffer of exactly `lay.F` bytes, after
    it.  On CUDA one launch on the current stream, which does not
    synchronise; on the CPU the plain twin."""
    H, W = lay.H, lay.W
    if flat.dtype != torch.uint8 or flat.dim() != 1 or not flat.is_contiguous():
        raise ValueError("pyramid_levels: flat must be a contiguous uint8 [F] buffer")
    if flat.shape[0] != lay.F:
        raise ValueError(f"pyramid_levels: flat holds {flat.shape[0]} bytes, the "
                         f"{H}x{W} pyramid {lay.F}")
    if lay.F >= 2**31:
        raise ValueError("pyramid_levels: the pyramid does not fit an int32 index")
    if flat.device.type == "cpu":
        fill_levels_reference(flat, lay)
        return
    if flat.device.type != "cuda":
        raise ValueError(f"pyramid_levels: no kernel for device {flat.device}")
    if flat.data_ptr() % 4:
        raise ValueError("pyramid_levels: flat must start on a 4-byte boundary")
    (_, _), (hh, hw), (qh, qw) = lay.dims
    (hx, hy), (qx, qy) = lay.ratios
    launched = ctypes.c_int(0)
    rc = _lib().pyramid_levels(
        flat.data_ptr(), H, W, hh, hw, qh, qw, float(hx), float(hy), float(qx), float(qy),
        torch.cuda.current_stream(flat.device).cuda_stream, ctypes.byref(launched),
    )
    if rc != 0:
        raise RuntimeError(f"pyramid_levels: launch failed, cudaError {rc}")
    tracing.count("pyramid_kernel.launches", launched.value)

