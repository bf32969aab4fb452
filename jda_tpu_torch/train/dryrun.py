"""Multi-device dry runs and rank bodies of the sharded paths.

PyTorch counterpart of the JAX package's train/dryrun.py.  Every function
here takes a 1-D DeviceMesh over "dp" and runs inside one rank of an SPMD
group (jda_tpu_torch.entry.run_on_mesh starts them): every rank calls it
with the same arguments and draws the same data from the same seed.

  * sharded_train_step_dryrun: one split-search step (both split types)
    over a tiny synthetic corpus sharded over the samples, checked against
    the single-program split search;
  * sharded_trainer_dryrun: one real Trainer cart on the mesh (the split
    search, the descent, the all-reduced ridge), checked against the
    single-device ridge;
  * sharded_splits, sharded_ridge, train_on_mesh, detect_on_mesh: the
    bodies these and the tests run, each returning what every rank must
    hold alike.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from jda_tpu_torch.train import features as FT
from jda_tpu_torch.train import regression as RG
from jda_tpu_torch.train import split as SP
from jda_tpu_torch.train.sharded import ShardedOps, ridge_lbf_sharded
from jda_tpu_torch.utils import dp_mesh


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def sharded_splits(mesh, corpus: Dict) -> Dict:
    """Both split searches of one node whose rows are the whole corpus,
    each rank computing the feature values of its slab only.

    corpus: flat_pos / flat_neg (uint8 [M * D] flat rows), dims (the three
    patch sizes), shapes_pos / shapes_neg ([M, 2L] f32), w_pos / w_neg
    ([M] f32, quantized as DataSet.update_weights does), pool (a
    FeaturePool), resid ([Mp, 2] f32), has_gt ([Mp] bool), u ([F] f32).
    Returns {"classification" | "regression": (feature, threshold, metric,
    positives' column, negatives' column)} on the host."""
    ops = ShardedOps(mesh)
    dev = ops.device
    pool = corpus["pool"].device(dev)
    n_p, n_n = len(corpus["shapes_pos"]), len(corpus["shapes_neg"])

    def slab_values(flat, shapes, n):
        rows = ops.shard(n)
        geom = FT.corpus_geometry(n, corpus["dims"])
        geom = {k: torch.as_tensor(v[rows], device=dev) for k, v in geom.items()}
        return rows, FT.feature_values(
            torch.as_tensor(flat, device=dev), geom,
            torch.as_tensor(shapes[rows], device=dev), pool,
        )

    rp, vp = slab_values(corpus["flat_pos"], corpus["shapes_pos"], n_p)
    rn, vn = slab_values(corpus["flat_neg"], corpus["shapes_neg"], n_n)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    cls = ops.classification_split(
        vp, t(corpus["w_pos"][rp]), vn, t(corpus["w_neg"][rn]), n_p, n_n
    )
    reg = ops.regression_split(
        vp, t(corpus["resid"][rp]), t(corpus["has_gt"][rp]), t(corpus["u"]), vn, n_p, n_n
    )
    return {
        "classification": tuple(_host(x) for x in cls),
        "regression": tuple(_host(x) for x in reg),
    }


def sharded_ridge(mesh, leaves: np.ndarray, resid: np.ndarray, F: int) -> np.ndarray:
    """ridge_lbf_sharded of the whole (leaves, residuals) on every rank."""
    return ridge_lbf_sharded(ShardedOps(mesh), leaves, resid, F)


def sharded_train_step_dryrun(mesh) -> None:
    """One split-search step over a tiny corpus (dims (12, 9, 6), L=5,
    F=32, 8 positives and 16 negatives per rank), every rank drawing the
    whole corpus from the same seed and computing its slab; the decisions
    and the gathered columns must equal the single-program split search on
    the whole corpus."""
    nd = mesh.size()
    dims, L, F = (12, 9, 6), 5, 32
    D = sum(d * d for d in dims)
    Mp, Mn = 8 * nd, 16 * nd
    rng = np.random.default_rng(0)
    w = np.round(rng.uniform(0.1, 1.0, Mp + Mn) / (Mp + Mn) * 2.0**23) / 2.0**23
    corpus = dict(
        flat_pos=rng.integers(0, 256, Mp * D).astype(np.uint8),
        flat_neg=rng.integers(0, 256, Mn * D).astype(np.uint8),
        dims=dims,
        shapes_pos=rng.uniform(0.2, 0.8, (Mp, 2 * L)).astype(np.float32),
        shapes_neg=rng.uniform(0.2, 0.8, (Mn, 2 * L)).astype(np.float32),
        w_pos=w[:Mp].astype(np.float32),
        w_neg=w[Mp:].astype(np.float32),
        pool=FT.gen_feature_pool(rng, F, L, 0.3, multi_scale=True),
        resid=rng.normal(0, 0.1, (Mp, 2)).astype(np.float32),
        has_gt=rng.uniform(size=Mp) > 0.1,
        u=rng.uniform(0.1, 0.9, F).astype(np.float32),
    )
    got = sharded_splits(mesh, corpus)

    # the single-program split search on the whole corpus, on this device
    dev = dp_mesh(mesh)[3]
    pool = corpus["pool"].device(dev)

    def t(a):
        return torch.as_tensor(a, device=dev)

    def values(flat, shapes):
        geom = {k: t(v) for k, v in FT.corpus_geometry(len(shapes), dims).items()}
        return FT.feature_values(t(flat), geom, t(shapes), pool)

    vp = values(corpus["flat_pos"], corpus["shapes_pos"])
    vn = values(corpus["flat_neg"], corpus["shapes_neg"])
    ones_p = torch.ones(Mp, dtype=torch.bool, device=dev)
    want = {
        "classification": SP.classification_split(
            vp, t(corpus["w_pos"]), ones_p,
            vn, t(corpus["w_neg"]), torch.ones(Mn, dtype=torch.bool, device=dev),
        ),
        "regression": SP.regression_split(
            vp, t(corpus["resid"]), t(corpus["has_gt"]), ones_p, t(corpus["u"])
        ),
    }
    for kind, (f, th, e) in want.items():
        gf, gth, ge, col_p, col_n = got[kind]
        assert 0 <= gf < F and -256 <= gth <= 255
        assert (gf, gth, float(ge)) == (int(f), int(th), float(e)), (
            f"sharded {kind} split ({gf}, {gth}, {float(ge)}) != single-program "
            f"({int(f)}, {int(th)}, {float(e)})"
        )
        assert np.array_equal(col_p, _host(vp[:, gf])) and np.array_equal(
            col_n, _host(vn[:, gf])
        ), f"sharded {kind} split: gathered columns differ"


def train_on_mesh(
    mesh,
    c,
    rows: np.ndarray,
    gts: np.ndarray,
    bgs,
    *,
    mining_max_batches: int,
    mining_batch: int = 2048,
    model=None,
    device=None,
) -> Dict:
    """Trainer(c, model, mesh=mesh).train() on a synthetic corpus (`mesh`
    None: one device, `device`).  Returns what every rank must hold alike
    and what the single-device trainer must hold too: the model, the live
    masks, the generator's next draw; and the run's seconds, the trainer's
    stats and, on a mesh, the collectives' stats and the largest exact sum."""
    from jda_tpu_torch.train.boost import Trainer

    tr = Trainer(c, model=copy.deepcopy(model), mesh=mesh, device=device)
    tr.mining_max_batches = mining_max_batches
    tr.mining_batch = mining_batch
    tr.set_synthetic_data(rows, gts, bgs)
    t0 = time.perf_counter()
    tr.train()
    if tr.device.type == "cuda":
        torch.cuda.synchronize(tr.device)
    seconds = time.perf_counter() - t0
    return {
        "model": tr.model,
        "pos_live": tr.pos.live.copy(),
        "neg_live": tr.neg.live.copy(),
        "next_draw": int(tr.rng.integers(1 << 62)),
        "seconds": seconds,
        "stats": tr.stats,
        "collectives": tr.ops.collective_stats() if tr.ops is not None else None,
        "max_abs_sum": tr.ops.max_abs_sum if tr.ops is not None else None,
    }


def sharded_trainer_dryrun(mesh) -> None:
    """Train one real Trainer cart on the mesh (T=1, K=4, landmark_n=5,
    seed 3; 64 faces, 3 backgrounds): the sharded split search, the
    descent of the score update, and the all-reduced ridge, whose W must
    equal the single-device ridge's on this rank's device."""
    from jda_tpu_torch.config import Config
    from jda_tpu_torch.data import DataSet, patch_row
    from jda_tpu_torch.train.boost import Trainer

    c = Config(
        T=1, K=4, landmark_n=5, tree_depth=4, shift_size=0.05, multi_scale=False,
        img_o_size=24, img_h_size=18, img_q_size=12, mining_th=(0.5,), feats=(24,),
        radius=(0.3,), probs=(0.5,), recall=(0.99,), drops=(1,), nps=(1.0,),
        score_normalization_steps=(1,), restart_on=False, face_augment_on=False,
        left_pupils=(0,), right_pupils=(1,), snapshot_iter=10_000, seed=3,
    )
    rng = np.random.default_rng(0)
    rows, gts = [], []
    for _ in range(64):
        img = rng.integers(40, 220, (c.img_o_size, c.img_o_size)).astype(np.uint8)
        rows.append(patch_row(img, c))
        gts.append(rng.uniform(0.2, 0.8, 2 * c.landmark_n))
    bgs = [rng.integers(0, 256, (80, 80)).astype(np.uint8) for _ in range(3)]
    tr = Trainer(c, mesh=mesh)
    tr.mining_max_batches = 10
    tr.set_synthetic_data(np.stack(rows), np.stack(gts), bgs)
    tr.more_neg_samples(0, 0)
    DataSet.update_weights(tr.pos, tr.neg)
    tr.train_cart(0, 0)
    tr.update_scores(tr.pos, 0, 0)
    tr.update_scores(tr.neg, 0, 0)
    # -256 is the untrained-node sentinel: a trained cart splits its root
    assert (tr.model.feat_th[0, 0] != -256).any()
    assert np.isfinite(tr.model.leaf_scores[0, 0]).all()
    lbf = tr.gen_lbf(tr.pos, 0)
    resid = tr.pos.shape_residual(tr.pos.live_idx()).astype(np.float32)
    W = ridge_lbf_sharded(tr.ops, lbf, resid, c.lbf_dim)
    assert W.shape == (c.lbf_dim, 2 * c.landmark_n) and np.isfinite(W).all()
    want = RG.ridge_lbf(lbf, resid, c.lbf_dim, device=tr.device)
    assert np.array_equal(W, want), "sharded ridge differs from the single-device ridge"


def detect_on_mesh(mesh, params, imgs, env: Optional[Dict[str, str]] = None, **kw) -> Dict:
    """Detector(params) on this rank's device through
    detect_batch(imgs, mesh=mesh, **kw), with the environment variables of
    `env` set around the call (e.g. JDA_TPU_FUSED).  Returns the results
    and the launches of the two stage-0 kernels (dense0_filter,
    dense0_image) during the call."""
    from jda_tpu_torch import tracing
    from jda_tpu_torch.detect import Detector

    det = Detector(params, device=dp_mesh(mesh)[3])
    saved = {k: os.environ.get(k) for k in env or {}}
    os.environ.update(env or {})
    try:
        with tracing.counting() as n:
            results = det.detect_batch(imgs, mesh=mesh, **kw)
        launches = (n.get("dense0_filter.launches", 0), n.get("dense0_image.launches", 0))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return {"results": results, "launches": launches}
