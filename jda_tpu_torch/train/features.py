"""Shape-indexed pixel-difference features, batched over (sample, feature).

PyTorch counterpart of the JAX package's train/features.py.  The reference
evaluates one feature on one sample at a time (Feature::CalcFeatureValue,
data.cpp:18-58) inside an OpenMP loop (DataSet::CalcFeatureValues,
data.cpp:148-173).  Here the whole [M, F] matrix is two batched reads:

    pix = base[m, scale[f]] + y * stride[m, scale[f]] + x
    val = flat[pix1] - flat[pix2]

with the detection tail's addressing scheme (ops/cascade.py), so corpora
and image pyramids share one code path.

Coordinates follow the C++ training semantics: round half away from zero
of (shape + offset) * size in float32, then clamp.  The shapes must be the
float32 mirror (DataSet.shapes_dev), never the float64 host array.

Feature pools are drawn on the host from a numpy Generator, with the
semantics of Cart::GenFeaturePool (cart.cpp:352-390): offsets
rejection-sampled from the unit disk scaled by the stage radius, uniform
landmark pair, uniform scale in {O,H,Q} when multi_scale else ORIGIN.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from jda_tpu_torch.ops.cascade import round_half_away

Tensor = torch.Tensor


@dataclasses.dataclass
class FeaturePool:
    """SoA pool of F candidate split features."""

    scale: np.ndarray  # [F] int32 in {0, 1, 2}
    lmk1: np.ndarray  # [F] int32
    lmk2: np.ndarray  # [F] int32
    off1: np.ndarray  # [F, 2] float32 (mean-shape-frame offsets)
    off2: np.ndarray  # [F, 2] float32

    def __len__(self) -> int:
        return len(self.scale)

    def select(self, i: int) -> Tuple[int, int, int, np.ndarray, np.ndarray]:
        return (
            int(self.scale[i]),
            int(self.lmk1[i]),
            int(self.lmk2[i]),
            self.off1[i].copy(),
            self.off2[i].copy(),
        )

    def device(self, device: Union[str, torch.device]) -> Dict[str, Tensor]:
        def t(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

        return {
            "scale": t(self.scale, np.int64),
            "lmk1": t(self.lmk1, np.int64),
            "lmk2": t(self.lmk2, np.int64),
            "off1": t(self.off1, np.float32),
            "off2": t(self.off2, np.float32),
        }


def gen_feature_pool(
    rng: np.random.Generator,
    n: int,
    landmark_n: int,
    radius: float,
    multi_scale: bool,
) -> FeaturePool:
    """Random pool, semantics of Cart::GenFeaturePool (cart.cpp:352-390)."""

    def unit_disk(k):
        pts = rng.uniform(-1.0, 1.0, (k, 2))
        bad = (pts**2).sum(-1) > 1.0
        while bad.any():
            pts[bad] = rng.uniform(-1.0, 1.0, (int(bad.sum()), 2))
            bad = (pts**2).sum(-1) > 1.0
        return pts

    scale = (
        rng.integers(0, 3, n).astype(np.int32)
        if multi_scale
        else np.zeros(n, np.int32)
    )
    return FeaturePool(
        scale=scale,
        lmk1=rng.integers(0, landmark_n, n).astype(np.int32),
        lmk2=rng.integers(0, landmark_n, n).astype(np.int32),
        off1=(unit_disk(n) * radius).astype(np.float32),
        off2=(unit_disk(n) * radius).astype(np.float32),
    )


def corpus_geometry(n: int, dims: Tuple[int, int, int]) -> Dict[str, np.ndarray]:
    """Per-sample scale geometry for a corpus stored as [N, D] flat patches.

    D = sum(d*d); sample i's scale-s patch starts at i*D + offset[s] in the
    flattened [N*D] buffer, so a training corpus is addressable by the same
    (base, stride, pw, ph) scheme as detection windows.
    """
    D = sum(d * d for d in dims)
    offs = np.cumsum([0] + [d * d for d in dims[:-1]])
    base = (np.arange(n, dtype=np.int64)[:, None] * D + offs[None, :]).astype(
        np.int32
    )
    dims_a = np.asarray(dims, np.int32)
    stride = np.broadcast_to(dims_a, (n, 3)).copy()
    return {"base": base, "stride": stride, "pw": stride.copy(), "ph": stride.copy()}


def _offsets(off: Tensor, stp: Optional[Tensor], M: int) -> Tuple[Tensor, Tensor]:
    """[M, F] x and y offsets: the mean-frame offsets, rotated and scaled
    into each sample's frame by stp[m] (STParameter::Apply, data.cpp:41-42)
    in the op order of ops/cascade.carts_descend."""
    ox, oy = off[None, :, 0], off[None, :, 1]
    if stp is None:
        return ox.expand(M, -1), oy.expand(M, -1)
    return (
        stp[:, 0, 0, None] * ox + stp[:, 0, 1, None] * oy,
        stp[:, 1, 0, None] * ox + stp[:, 1, 1, None] * oy,
    )


def feature_values_mxu(
    canvas: Tensor,  # [M, S, S] uint8 origin-scale patches
    shapes: Tensor,  # [M, 2L] float32
    pool: Dict[str, Tensor],  # device FeaturePool (single-scale)
    stp: Optional[Tensor] = None,
) -> Tensor:
    """[M, F] int32 feature matrix of a single-scale pool over square
    [S, S] patches.  The JAX package reads the pixels with one-hot int8
    matmuls (its TPU's gathers are slow); on the card this is a plain
    gather that returns the same values.  The name stays the JAX
    package's."""
    M, S, _ = canvas.shape
    sx, sy = shapes[:, 0::2], shapes[:, 1::2]
    rows = torch.arange(M, device=canvas.device)[:, None]
    Sf = torch.tensor(float(S), dtype=torch.float32, device=canvas.device)

    def sample(lmk: Tensor, off: Tensor) -> Tensor:
        ox, oy = _offsets(off, stp, M)
        x = round_half_away((sx[:, lmk] + ox) * Sf).clamp(0, S - 1)
        y = round_half_away((sy[:, lmk] + oy) * Sf).clamp(0, S - 1)
        return canvas[rows, y.long(), x.long()].to(torch.int32)

    return sample(pool["lmk1"], pool["off1"]) - sample(pool["lmk2"], pool["off2"])


def feature_values(
    flat: Tensor,  # [total] uint8 flat image buffer
    geom: Dict[str, Tensor],  # base/stride/pw/ph, each [M, 3]
    shapes: Tensor,  # [M, 2L] float32
    pool: Dict[str, Tensor],  # device FeaturePool
    stp: Optional[Tensor] = None,  # [M, 2, 2] similarity (rot*scale)
) -> Tensor:
    """[M, F] int32 feature matrix (C++ training semantics: round + clamp),
    any pool: each feature reads the pyramid level of its `scale`."""
    M = shapes.shape[0]
    sx, sy = shapes[:, 0::2], shapes[:, 1::2]
    sc = pool["scale"]
    base = geom["base"][:, sc].long()  # [M, F]
    stride = geom["stride"][:, sc].long()
    pw = geom["pw"][:, sc]
    ph = geom["ph"][:, sc]
    pwf = pw.to(torch.float32)
    phf = ph.to(torch.float32)

    def sample(lmk: Tensor, off: Tensor) -> Tensor:
        ox, oy = _offsets(off, stp, M)
        x = torch.minimum(round_half_away((sx[:, lmk] + ox) * pwf).clamp(min=0), pw - 1)
        y = torch.minimum(round_half_away((sy[:, lmk] + oy) * phf).clamp(min=0), ph - 1)
        return flat[base + y.long() * stride + x.long()].to(torch.int32)

    return sample(pool["lmk1"], pool["off1"]) - sample(pool["lmk2"], pool["off2"])
