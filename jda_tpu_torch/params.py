"""Flattened cascade model: structure-of-arrays over all T*K carts.

PyTorch counterpart of the JAX package's params module.  The model lives on
the host as numpy arrays, one per field spanning every cart:

    scale       [T, K, 7]   int32   pyramid level per internal node (0/1/2)
    lmk1, lmk2  [T, K, 7]   int32   landmark ids per internal node
    off1, off2  [T, K, 7,2] float   (x, y) offsets in mean-shape frame
    feat_th     [T, K, 7]   int32   pixel-difference split threshold
    leaf_scores [T, K, 8]   float   RealBoost leaf scores
    cart_th     [T, K]      float   per-cart rejection threshold
    mean, std   [T, K]      float   score normalisation
    W           [T, K*8, 2L] float  per-stage global-regression weights
    mean_shape  [2L]        float

and `device_tensors` places it on a torch device for the compute path.

Internal nodes are 0-based (node 0 = root; children of i are 2i+1 / 2i+2;
leaf index = final_node - 7), matching the C library's nodes[0..6]
(c/jda.c:369-395).

Binary model formats are bit-compatible with the reference:
  * "double" format written by JoinCascador::SerializeTo
    (src/jda/cascador.cpp:79-124 + src/jda/cart.cpp:429-450)
  * "float" format written by jdaCascadorSerializeTo (c/jda.c:644-716)
"""

from __future__ import annotations

import dataclasses
import io
from typing import Mapping, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass
class CascadeParams:
    """Model arrays (numpy on host; `device_tensors()` returns torch tensors)."""

    T: int
    K: int
    landmark_n: int
    tree_depth: int
    # training cursor (cascador.hpp:125-139 semantics)
    stage_idx: int
    cart_idx: int

    mean_shape: np.ndarray  # [2L] f64
    scale: np.ndarray  # [T, K, node_n] i32
    lmk1: np.ndarray  # [T, K, node_n] i32
    lmk2: np.ndarray  # [T, K, node_n] i32
    off1: np.ndarray  # [T, K, node_n, 2] f64
    off2: np.ndarray  # [T, K, node_n, 2] f64
    feat_th: np.ndarray  # [T, K, node_n] i32
    leaf_scores: np.ndarray  # [T, K, leaf_n] f64
    cart_th: np.ndarray  # [T, K] f64
    mean: np.ndarray  # [T, K] f64
    std: np.ndarray  # [T, K] f64
    W: np.ndarray  # [T, K*leaf_n, 2L] f64

    @property
    def leaf_n(self) -> int:
        return 1 << (self.tree_depth - 1)

    @property
    def node_n(self) -> int:
        return self.leaf_n - 1

    @property
    def landmark_dim(self) -> int:
        return 2 * self.landmark_n

    def describe_cart(self, t: int, k: int) -> str:
        """Human-readable dump of one cart (Cart::PrintSelf,
        cart.cpp:452-471).  The integer fields print as their int32 values
        and the float fields with four decimals."""
        lines = [f"Cart (stage {t+1}, cart {k+1})", "node parameters"]
        for i in range(self.node_n):
            lines.append(
                f"  node {i+1}: [scale = {self.scale[t,k,i]}, "
                f"th = {self.feat_th[t,k,i]}, "
                f"landmark_1 = ({self.lmk1[t,k,i]}, "
                f"{self.off1[t,k,i,0]:.4f}, {self.off1[t,k,i,1]:.4f}), "
                f"landmark_2 = ({self.lmk2[t,k,i]}, "
                f"{self.off2[t,k,i,0]:.4f}, {self.off2[t,k,i,1]:.4f})]"
            )
        leaf = ", ".join(f"{v:.4f}" for v in self.leaf_scores[t, k])
        lines.append(f"leaf scores: [{leaf}]")
        lines.append(
            f"mean = {self.mean[t,k]:.4f}, std = {self.std[t,k]:.4f}, "
            f"threshold = {self.cart_th[t,k]:.4f}"
        )
        return "\n".join(lines)

    def astype(self, dtype) -> "CascadeParams":
        """Cast float fields (float32 mirrors the C library's model)."""
        return dataclasses.replace(
            self,
            mean_shape=self.mean_shape.astype(dtype),
            off1=self.off1.astype(dtype),
            off2=self.off2.astype(dtype),
            leaf_scores=self.leaf_scores.astype(dtype),
            cart_th=self.cart_th.astype(dtype),
            mean=self.mean.astype(dtype),
            std=self.std.astype(dtype),
            W=self.W.astype(dtype),
        )

    def device_tensors(
        self, device: Union[str, torch.device], dtype: torch.dtype = torch.float32
    ) -> dict:
        """Dict of tensors on `device` for the compute path (float32 by
        default; float fields are rounded through numpy float32 first, as
        the JAX package's device_arrays does)."""
        np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]

        def ints(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)

        def floats(a):
            return torch.as_tensor(np.ascontiguousarray(a, np_dtype), device=device)

        return {
            "scale": ints(self.scale),
            "lmk1": ints(self.lmk1),
            "lmk2": ints(self.lmk2),
            "off1": floats(self.off1),
            "off2": floats(self.off2),
            "feat_th": ints(self.feat_th),
            "leaf_scores": floats(self.leaf_scores),
            "cart_th": floats(self.cart_th),
            "mean": floats(self.mean),
            "std": floats(self.std),
            "W": floats(self.W),
            "mean_shape": floats(self.mean_shape),
        }


_INT_FIELDS = ("T", "K", "landmark_n", "tree_depth", "stage_idx", "cart_idx")
_I32_FIELDS = ("scale", "lmk1", "lmk2", "feat_th")


def from_arrays(fields: Mapping[str, Union[np.ndarray, int]]) -> CascadeParams:
    """Build a CascadeParams from a mapping of its fields, such as
    `dataclasses.asdict` of the JAX package's model: both packages then
    compute on the same numbers."""
    names = [f.name for f in dataclasses.fields(CascadeParams)]
    missing = [n for n in names if n not in fields]
    if missing:
        raise KeyError(f"from_arrays: missing fields {missing}")
    kw = {}
    for n in names:
        v = fields[n]
        if n in _INT_FIELDS:
            kw[n] = int(v)
        elif n in _I32_FIELDS:
            kw[n] = np.array(v, np.int32)
        else:
            kw[n] = np.array(v, np.float64)
    return CascadeParams(**kw)


# ---------------------------------------------------------------------------
# Binary (de)serialization
# ---------------------------------------------------------------------------

def _node_dtype(f: str) -> np.dtype:
    # packed layout of one internal node record:
    # int32 scale, int32 lmk1, int32 lmk2, f off1x, f off1y, f off2x, f off2y,
    # int32 th   (cart.cpp:431-440 for f8; c/jda.c:673-690 for f4)
    return np.dtype(
        [
            ("scale", "<i4"),
            ("lmk1", "<i4"),
            ("lmk2", "<i4"),
            ("off", "<" + f, (4,)),
            ("th", "<i4"),
        ]
    )


def _cart_dtype(f: str, node_n: int, leaf_n: int) -> np.dtype:
    # nodes, leaf scores, cart threshold, mean, std (cart.cpp:429-450)
    return np.dtype(
        [
            ("nodes", _node_dtype(f), (node_n,)),
            ("leaf", "<" + f, (leaf_n,)),
            ("th", "<" + f),
            ("mean", "<" + f),
            ("std", "<" + f),
        ]
    )


def _read(buf: io.BufferedReader, dtype, count: int) -> np.ndarray:
    dt = np.dtype(dtype)
    raw = buf.read(dt.itemsize * count)
    if len(raw) != dt.itemsize * count:
        raise ValueError("truncated model file")
    return np.frombuffer(raw, dtype=dt, count=count)


def load_model(
    path: str, dtype: str = "double", check: bool = True
) -> CascadeParams:
    """Load a reference-format binary model.

    dtype="double": format of JoinCascador::SerializeTo (cascador.cpp:79-124).
    dtype="float":  format of jdaCascadorSerializeTo (c/jda.c:644-716).
    check=True rejects models whose cursor marks complete a stage with
    trained carts but an all-zero W (see check_complete_stages).
    """
    f = "f8" if dtype == "double" else "f4"
    with open(path, "rb") as fin:
        header = _read(fin, "<i4", 7)
        _mask, T, K, landmark_n, tree_depth, stage_idx, cart_idx = (
            int(x) for x in header
        )
        node_n = (1 << (tree_depth - 1)) - 1
        leaf_n = node_n + 1
        L2 = 2 * landmark_n
        mean_shape = _read(fin, f, L2).astype(np.float64)

        scale = np.zeros((T, K, node_n), np.int32)
        lmk1 = np.zeros((T, K, node_n), np.int32)
        lmk2 = np.zeros((T, K, node_n), np.int32)
        off1 = np.zeros((T, K, node_n, 2), np.float64)
        off2 = np.zeros((T, K, node_n, 2), np.float64)
        feat_th = np.zeros((T, K, node_n), np.int32)
        leaf_scores = np.zeros((T, K, leaf_n), np.float64)
        cart_th = np.zeros((T, K), np.float64)
        mean = np.zeros((T, K), np.float64)
        std = np.zeros((T, K), np.float64)
        W = np.zeros((T, K * leaf_n, L2), np.float64)

        cart_dt = _cart_dtype(f, node_n, leaf_n)
        for t in range(T):
            carts = _read(fin, cart_dt, K)
            scale[t] = carts["nodes"]["scale"]
            lmk1[t] = carts["nodes"]["lmk1"]
            lmk2[t] = carts["nodes"]["lmk2"]
            off1[t] = carts["nodes"]["off"][..., 0:2]
            off2[t] = carts["nodes"]["off"][..., 2:4]
            feat_th[t] = carts["nodes"]["th"]
            leaf_scores[t] = carts["leaf"]
            cart_th[t] = carts["th"]
            mean[t] = carts["mean"]
            std[t] = carts["std"]
            W[t] = _read(fin, f, K * leaf_n * L2).reshape(K * leaf_n, L2)
        _read(fin, "<i4", 1)  # trailing mask

    out = CascadeParams(
        T=T,
        K=K,
        landmark_n=landmark_n,
        tree_depth=tree_depth,
        stage_idx=stage_idx,
        cart_idx=cart_idx,
        mean_shape=mean_shape,
        scale=scale,
        lmk1=lmk1,
        lmk2=lmk2,
        off1=off1,
        off2=off2,
        feat_th=feat_th,
        leaf_scores=leaf_scores,
        cart_th=cart_th,
        mean=mean,
        std=std,
        W=W,
    )
    if check:
        check_complete_stages(out, f"load_model({path})")
    return out


def _stage_missing_regression(params: CascadeParams, t: int) -> bool:
    """True when stage t has trained carts but an all-zero regression matrix:
    a cursor that marks such a stage complete describes a model whose
    stage-end global regression never ran.  Stages finalized as
    pass-through (leaf scores all zero) legitimately carry W == 0."""
    return bool(np.any(params.leaf_scores[t]) and not np.any(params.W[t]))


def check_complete_stages(params: CascadeParams, where: str) -> None:
    """Refuse cursors that mark a regression-less stage as complete."""
    done = min(max(params.stage_idx, 0), params.T)
    for t in range(done):
        if _stage_missing_regression(params, t):
            raise ValueError(
                f"{where}: cursor ({params.stage_idx}, {params.cart_idx}) "
                f"marks stage {t} complete, but its regression matrix W[{t}] "
                "is all zero while its carts are trained — the stage-end "
                "global regression never ran (or its result was lost). "
                "Re-run the stage's regression or save with "
                "allow_incomplete_stage=True to keep a resumable cursor."
            )


def save_model(
    params: CascadeParams,
    path: str,
    dtype: str = "double",
    allow_incomplete_stage: bool = False,
) -> None:
    """Write a reference-format binary model (see load_model).

    Refuses to write a cursor that declares complete a stage whose carts
    are trained but whose W is all zero (see check_complete_stages) —
    unless allow_incomplete_stage is set, in which case the cursor is
    written as (stage, K-2) so resume retrains the last cart and then runs
    the stage's global regression.
    """
    f = "f8" if dtype == "double" else "f4"
    fdt = np.dtype("<" + f)
    T, K = params.T, params.K
    node_n, leaf_n = params.node_n, params.leaf_n

    # the C serializer stamps stage_idx = T+1, cart_idx = -1 (c/jda.c:662-665);
    # the C++ serializer writes the live training cursor with the (stage, K-1)
    # -> (stage+1, -1) rollover (cascador.cpp:93-104)
    if dtype == "float":
        stage_idx, cart_idx = T + 1, -1
    elif params.cart_idx == K - 1:
        if _stage_missing_regression(params, params.stage_idx):
            if not allow_incomplete_stage:
                check_complete_stages(
                    dataclasses.replace(
                        params,
                        stage_idx=params.stage_idx + 1,
                        cart_idx=-1,
                    ),
                    f"save_model({path})",
                )
            # resumable mid-stage cursor: retrain cart K-1, then regression
            stage_idx, cart_idx = params.stage_idx, K - 2
        else:
            stage_idx, cart_idx = params.stage_idx + 1, -1
    else:
        stage_idx, cart_idx = params.stage_idx, params.cart_idx
    if dtype != "float" and not allow_incomplete_stage:
        check_complete_stages(
            dataclasses.replace(
                params, stage_idx=stage_idx, cart_idx=cart_idx
            ),
            f"save_model({path})",
        )

    with open(path, "wb") as fout:
        np.asarray(
            [0, T, K, params.landmark_n, params.tree_depth, stage_idx, cart_idx],
            "<i4",
        ).tofile(fout)
        params.mean_shape.astype(fdt).tofile(fout)
        cart_dt = _cart_dtype(f, node_n, leaf_n)
        for t in range(T):
            carts = np.zeros(K, cart_dt)
            carts["nodes"]["scale"] = params.scale[t]
            carts["nodes"]["lmk1"] = params.lmk1[t]
            carts["nodes"]["lmk2"] = params.lmk2[t]
            carts["nodes"]["off"][..., 0:2] = params.off1[t]
            carts["nodes"]["off"][..., 2:4] = params.off2[t]
            carts["nodes"]["th"] = params.feat_th[t]
            carts["leaf"] = params.leaf_scores[t]
            carts["th"] = params.cart_th[t]
            carts["mean"] = params.mean[t]
            carts["std"] = params.std[t]
            carts.tofile(fout)
            params.W[t].astype(fdt).tofile(fout)
        np.asarray([0], "<i4").tofile(fout)


# ---------------------------------------------------------------------------
# Synthetic models: random but structurally valid cascades, the same
# numbers as the JAX package's for the same arguments.
# ---------------------------------------------------------------------------

def realistic_drop_profile(T: int, K: int) -> np.ndarray:
    """Per-cart conditional drop rates shaped like a trained cascade.

    Trained JDA models front-load rejection — most non-face windows die in
    the first carts (src/jda/data.cpp:1053-1059) — and every stage keeps
    rejecting, since hard negatives are re-mined each stage against the
    partial cascade (data.cpp:971-1012).  Stage 0 kills ~99.5% of noise
    windows; each later stage passes roughly a third of what reaches it.
    """
    prof = np.full(T * K, 5e-4)
    prof[:32] = 0.06
    prof[32:128] = 0.02
    prof[128 : min(K, T * K)] = 0.004
    # stages >= 1: front-loaded rejection of the previous stage's survivors
    for t in range(1, T):
        s = t * K
        prof[s : s + min(64, K)] = 0.01
        prof[s + 64 : (t + 1) * K] = 0.001
    return prof


def synthetic_model(
    T: int = 2,
    K: int = 8,
    landmark_n: int = 27,
    tree_depth: int = 4,
    seed: int = 0,
    multi_scale: bool = False,
    reject_rate: float = 0.0,
    drop_profile: Optional[np.ndarray] = None,
) -> CascadeParams:
    """Random but structurally valid cascade (value ranges per cart.cpp:352-390).

    reject_rate > 0 raises cart thresholds so a cascade over random noise
    rejects windows early (mimicking a trained detector's behaviour).
    drop_profile (overrides reject_rate) gives per-cart *conditional* drop
    rates; thresholds are calibrated by simulating random-leaf score
    trajectories, so rejection is front-loaded like a trained cascade.
    """
    rng = np.random.default_rng(seed)
    node_n = (1 << (tree_depth - 1)) - 1
    leaf_n = node_n + 1
    L2 = 2 * landmark_n

    # mean shape roughly centred in the unit square, like a face template
    ms = np.stack(
        [
            rng.uniform(0.15, 0.85, landmark_n),
            rng.uniform(0.15, 0.85, landmark_n),
        ],
        axis=1,
    ).reshape(-1)

    def unit_disk(shape):
        # rejection-sampled unit-disk offsets, as GenFeaturePool does
        pts = rng.uniform(-1.0, 1.0, shape + (2,))
        bad = (pts**2).sum(-1) > 1.0
        while bad.any():
            pts[bad] = rng.uniform(-1.0, 1.0, (int(bad.sum()), 2))
            bad = (pts**2).sum(-1) > 1.0
        return pts

    radius = 0.3
    scale = (
        rng.integers(0, 3, (T, K, node_n)).astype(np.int32)
        if multi_scale
        else np.zeros((T, K, node_n), np.int32)
    )
    params = CascadeParams(
        T=T,
        K=K,
        landmark_n=landmark_n,
        tree_depth=tree_depth,
        stage_idx=T + 1,
        cart_idx=-1,
        mean_shape=ms,
        scale=scale,
        lmk1=rng.integers(0, landmark_n, (T, K, node_n)).astype(np.int32),
        lmk2=rng.integers(0, landmark_n, (T, K, node_n)).astype(np.int32),
        off1=unit_disk((T, K, node_n)) * radius,
        off2=unit_disk((T, K, node_n)) * radius,
        feat_th=rng.integers(-80, 81, (T, K, node_n)).astype(np.int32),
        leaf_scores=rng.normal(0.0, 0.3, (T, K, leaf_n)),
        cart_th=np.full((T, K), -1e9),
        mean=np.zeros((T, K)),
        std=np.ones((T, K)),
        W=rng.normal(0.0, 1e-4, (T, K * leaf_n, L2)),
    )
    if drop_profile is not None:
        # calibrate th_k so that a fraction drop_profile[k] of *surviving*
        # random trajectories falls below it at cart k.  When the surviving
        # pool thins out, dead trajectories are resampled onto live ones so
        # later stages keep a statistically meaningful pool to calibrate on.
        M = 1 << 16
        sim = np.random.default_rng(seed + 1)
        leaf_flat = params.leaf_scores.reshape(T * K, leaf_n)
        s = np.zeros(M)
        alive = np.ones(M, bool)
        th = np.full(T * K, -1e9)
        for k in range(T * K):
            s = s + leaf_flat[k, sim.integers(0, leaf_n, M)]
            n_live = int(alive.sum())
            if n_live and n_live < M // 64:
                # replenish: clone surviving trajectories into dead slots
                dead = np.flatnonzero(~alive)
                src = np.flatnonzero(alive)
                s[dead] = s[src[sim.integers(0, n_live, len(dead))]]
                alive[:] = True
                n_live = M
            live = s[alive]
            if n_live >= 256 and drop_profile[k] > 0:
                th[k] = np.quantile(live, drop_profile[k])
                alive &= s >= th[k]
        params = dataclasses.replace(params, cart_th=th.reshape(T, K))
    elif reject_rate > 0.0:
        # Running score after k carts is a random walk ~ N(0, 0.3*sqrt(k+1)).
        # Setting th_k at the reject_rate quantile of that marginal rejects a
        # roughly constant fraction of surviving windows at every cart.
        import math

        lo, hi = -10.0, 10.0
        for _ in range(80):  # bisect Phi(z) = reject_rate
            mid = 0.5 * (lo + hi)
            if 0.5 * (1.0 + math.erf(mid / math.sqrt(2.0))) < reject_rate:
                lo = mid
            else:
                hi = mid
        z = 0.5 * (lo + hi)
        k = np.arange(T * K, dtype=np.float64).reshape(T, K)
        sigma = 0.3 * np.sqrt(k + 1.0)
        params = dataclasses.replace(params, cart_th=z * sigma)

    return params
