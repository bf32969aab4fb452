"""The port's multi-device paths on the CPU: gloo process groups of 2 and 4
spawned processes (jda_tpu_torch.entry.MeshRun), against `jda_tpu`'s mesh
paths on the 8 virtual CPU devices of tests/conftest.py and against the
port on one device.

Both groups start first and run every case they serve in one spawn
(`run_each`), while this process computes the references; the rank bodies
are in jda_tpu_torch/train/dryrun.py, since spawned children import them
by module name.  Every result of the sharded ops and trainer is bit-equal
to the single-device port, W included (the sums are exact: see
jda_tpu_torch/train/sharded.py); against `jda_tpu`, W is within W_REL_TOL
(tests/torch_train_util.py), everything else bit-equal.
"""

import dataclasses
import datetime
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from jda_tpu import params as JP
from jda_tpu.detect import Detector as JDetector
from jda_tpu.train import features as JFT
from jda_tpu.train.boost import Trainer as JTrainer
from jda_tpu.train.sharded import ShardedOps as JShardedOps
from jda_tpu.train.sharded import ridge_lbf_sharded as j_ridge_lbf_sharded
from jda_tpu_torch import params as TP
from jda_tpu_torch.detect import Detector
from jda_tpu_torch.entry import MeshRun, dryrun_multichip, entry, run_each
from jda_tpu_torch.train import dryrun as DR
from jda_tpu_torch.train import features as FT
from jda_tpu_torch.train import regression as RG
from jda_tpu_torch.train import split as SP

from test_training import _tiny_config, build_synthetic
from torch_train_util import (  # noqa: F401 (fixture)
    EXACT_FIELDS, MINING_BATCH, W_REL_TOL, model_diffs, one_torch_thread, port_config, w_close,
)

DIMS, L, F = (12, 9, 6), 5, 24

# (positives, negatives, seed) per world size: uneven sizes, a rank with
# zero rows (1 row over 2 ranks, 3 over 4), an empty side of each kind
SPLIT_CASES = {
    2: [(37, 53, 0), (1, 20, 1), (9, 0, 2)],
    4: [(37, 53, 3), (3, 21, 4), (0, 10, 5)],
}

ONE_STAGE = dict(T=1, K=8, feats=(40,), radius=(0.3,), probs=(0.8,),
                 recall=(0.99,), drops=(1,), nps=(1.0,),
                 score_normalization_steps=(2,), mining_th=(0.5,),
                 restart_th=(0.001,))
TRAIN_VARIANTS = {
    "single-scale": {},
    "similarity-transform": dict(with_similarity_transform=True),
    "multi-scale": dict(multi_scale=True),
}

DETECT_KW = dict(scale=1.3, th=-10.0)
DETECT_SIZES = [(48, 64), (40, 56), (48, 60)]  # 3 images: not a multiple of 2


def _corpus(Mp, Mn, seed):
    """One node's corpus in the form of dryrun.sharded_splits, weights
    quantized as DataSet.update_weights quantizes them."""
    rng = np.random.default_rng(seed)
    D = sum(d * d for d in DIMS)
    w = rng.uniform(0.1, 1.0, Mp + Mn)
    w = np.round(w / max(w.sum(), 1e-30) * 2.0**23) / 2.0**23
    return dict(
        flat_pos=rng.integers(0, 256, Mp * D).astype(np.uint8),
        flat_neg=rng.integers(0, 256, Mn * D).astype(np.uint8),
        dims=DIMS,
        shapes_pos=rng.uniform(0.2, 0.8, (Mp, 2 * L)).astype(np.float32),
        shapes_neg=rng.uniform(0.2, 0.8, (Mn, 2 * L)).astype(np.float32),
        w_pos=w[:Mp].astype(np.float32),
        w_neg=w[Mp:].astype(np.float32),
        pool=FT.gen_feature_pool(rng, F, L, 0.3, multi_scale=True),
        resid=rng.normal(0, 0.1, (Mp, 2)).astype(np.float32),
        has_gt=rng.uniform(size=Mp) > 0.1,
        u=rng.uniform(0.1, 0.9, F).astype(np.float32),
    )


def _ridge_case():
    rng = np.random.default_rng(9)
    K, leaf_n, n = 24, 8, 301
    leaves = rng.integers(0, leaf_n, (n, K)) + np.arange(K)[None] * leaf_n
    return leaves.astype(np.int32), rng.normal(0, 0.05, (n, 10)).astype(np.float32), K * leaf_n


def _detect_case():
    m = JP.synthetic_model(T=2, K=16, landmark_n=5, seed=2, reject_rate=0.05)
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 256, hw).astype(np.uint8) for hw in DETECT_SIZES]
    return m, imgs


def _train_case(kw):
    c = _tiny_config(**ONE_STAGE, **kw)
    rows, gts, bgs = build_synthetic(c, n_pos=120)
    return c, rows, gts, bgs


def _calls(nd):
    """The rank bodies and their arguments that a group of nd ranks runs."""
    calls = [(DR.sharded_splits, (_corpus(*case),)) for case in SPLIT_CASES[nd]]
    calls.append((DR.sharded_ridge, _ridge_case()))
    if nd == 2:
        train = functools.partial(
            DR.train_on_mesh, mining_max_batches=20, mining_batch=MINING_BATCH
        )
        for kw in TRAIN_VARIANTS.values():
            c, rows, gts, bgs = _train_case(kw)
            calls.append((train, (port_config(c), rows, gts, bgs)))
        m, imgs = _detect_case()
        pm = TP.from_arrays(dataclasses.asdict(m))
        detect = functools.partial(DR.detect_on_mesh, **DETECT_KW)
        calls.append((detect, (pm, imgs)))
        calls.append((functools.partial(detect, env={"JDA_TPU_FUSED": "0"}), (pm, imgs)))
    return calls


# -- references -----------------------------------------------------------


def _jax_mesh(nd):
    return Mesh(np.array(jax.devices()[:nd]), ("dp",))


def _jax_splits(corpus, nd):
    """jda_tpu's ShardedOps on the same node, its rows padded to a multiple
    of nd as its trainer pads them (pad rows invalid)."""
    ops = JShardedOps(_jax_mesh(nd))
    p = corpus["pool"]
    pool = ops.replicate(JFT.FeaturePool(p.scale, p.lmk1, p.lmk2, p.off1, p.off2).device())

    def side(flat, shapes, n):
        b = nd * max(1, -(-n // nd))

        def pad(a):
            a = np.asarray(a)
            return np.concatenate([a, np.zeros((b - n,) + a.shape[1:], a.dtype)])

        geom = {k: ops.shard(jnp.asarray(pad(v))) for k, v in JFT.corpus_geometry(n, DIMS).items()}
        # pad rows read row 0: an empty side gets one zero row to read
        flat = flat if n else np.zeros(sum(d * d for d in DIMS), np.uint8)
        return (jnp.asarray(flat.astype(np.int32)), geom, ops.shard(jnp.asarray(pad(shapes))),
                ops.shard(jnp.asarray(np.arange(b) < n)), pad)

    Mp, Mn = len(corpus["shapes_pos"]), len(corpus["shapes_neg"])
    fp, gp, sp, vp, padp = side(corpus["flat_pos"], corpus["shapes_pos"], Mp)
    fn, gn, sn, vn, padn = side(corpus["flat_neg"], corpus["shapes_neg"], Mn)
    out = {}
    f, th, e, cp, cn = ops.classification_split(
        fp, gp, sp, ops.shard(jnp.asarray(padp(corpus["w_pos"]))), vp,
        fn, gn, sn, ops.shard(jnp.asarray(padn(corpus["w_neg"]))), vn, pool,
    )
    out["classification"] = (int(f), int(th), float(e), np.asarray(cp)[:Mp], np.asarray(cn)[:Mn])
    f, th, e, cp, cn = ops.regression_split(
        fp, gp, sp, ops.shard(jnp.asarray(padp(corpus["resid"]))),
        ops.shard(jnp.asarray(padp(corpus["has_gt"]))), vp, fn, gn, sn, pool,
        ops.replicate(jnp.asarray(corpus["u"])),
    )
    out["regression"] = (int(f), int(th), float(e), np.asarray(cp)[:Mp], np.asarray(cn)[:Mn])
    return out


def _single_splits(corpus):
    """The port's single-device split search on the whole node."""
    pool = corpus["pool"].device("cpu")

    def values(flat, shapes):
        geom = {k: torch.as_tensor(v) for k, v in FT.corpus_geometry(len(shapes), DIMS).items()}
        return FT.feature_values(torch.as_tensor(flat), geom, torch.as_tensor(shapes), pool)

    vp = values(corpus["flat_pos"], corpus["shapes_pos"])
    vn = values(corpus["flat_neg"], corpus["shapes_neg"])
    ones_p = torch.ones(len(vp), dtype=torch.bool)
    ones_n = torch.ones(len(vn), dtype=torch.bool)
    t = torch.as_tensor
    kinds = {
        "classification": SP.classification_split(
            vp, t(corpus["w_pos"]), ones_p, vn, t(corpus["w_neg"]), ones_n
        ),
        "regression": SP.regression_split(
            vp, t(corpus["resid"]), t(corpus["has_gt"]), ones_p, t(corpus["u"])
        ),
    }
    return {
        k: (int(f), int(th), float(e), vp[:, int(f)].numpy(), vn[:, int(f)].numpy())
        for k, (f, th, e) in kinds.items()
    }


def _detect_references():
    m, imgs = _detect_case()
    jres = JDetector(m).detect_batch(imgs, mesh=_jax_mesh(2), **DETECT_KW)
    det = Detector(TP.from_arrays(dataclasses.asdict(m)), device="cpu")
    fused = det.detect_batch(imgs, **DETECT_KW)
    saved = os.environ.get("JDA_TPU_FUSED")
    os.environ["JDA_TPU_FUSED"] = "0"
    try:
        unfused = det.detect_batch(imgs, **DETECT_KW)
    finally:
        if saved is None:
            os.environ.pop("JDA_TPU_FUSED")
        else:
            os.environ["JDA_TPU_FUSED"] = saved
    return jres, fused, unfused


@pytest.fixture(scope="module")
def runs():
    """Both groups' results, one list per rank in the order of _calls, and
    the references computed while they ran."""
    groups = {nd: MeshRun(run_each, nd, _calls(nd), device="cpu", limit=600) for nd in (2, 4)}
    try:
        ref = {"splits": {}, "jax_splits": {}, "train": {}}
        for nd, cases in SPLIT_CASES.items():
            for case in cases:
                corpus = _corpus(*case)
                ref["splits"][case] = _single_splits(corpus)
                ref["jax_splits"][case] = _jax_splits(corpus, nd)
        leaves, resid, Fr = _ridge_case()
        ref["ridge"] = RG.ridge_lbf(leaves, resid, Fr, device="cpu")
        ref["jax_ridge"] = {nd: j_ridge_lbf_sharded(JShardedOps(_jax_mesh(nd)), leaves, resid, Fr)
                            for nd in (2, 4)}
        for name, kw in TRAIN_VARIANTS.items():
            c, rows, gts, bgs = _train_case(kw)
            ref["train"][name] = DR.train_on_mesh(
                None, port_config(c), rows, gts, bgs, mining_max_batches=20,
                mining_batch=MINING_BATCH, device="cpu",
            )
        c, rows, gts, bgs = _train_case({})
        jtr = JTrainer(c)
        jtr.mining_max_batches = 20
        jtr.mining_batch = MINING_BATCH
        jtr.set_synthetic_data(rows, gts, bgs)
        jtr.train()
        ref["jax_train"] = jtr.model
        ref["detect"] = _detect_references()
        got = {nd: g.results() for nd, g in groups.items()}
    finally:
        for g in groups.values():
            g.close()
    return got, ref


def _same_split(got, want, what):
    assert got[:3] == want[:3], f"{what}: (feature, threshold, metric) {got[:3]} != {want[:3]}"
    np.testing.assert_array_equal(got[3], want[3], err_msg=f"{what}: positives' column")
    np.testing.assert_array_equal(got[4], want[4], err_msg=f"{what}: negatives' column")


@pytest.mark.parametrize("nd", [2, 4])
def test_split_ops_match_single_device_and_jax(runs, nd):
    """ShardedOps' classification and regression splits on every rank
    equal the port's single-device split search and jda_tpu's ShardedOps:
    feature, threshold, metric and both gathered columns."""
    got, ref = runs
    for i, case in enumerate(SPLIT_CASES[nd]):
        for rank in range(nd):
            res = got[nd][rank][i]
            for kind in ("classification", "regression"):
                g = (int(res[kind][0]), int(res[kind][1]), float(res[kind][2])) + res[kind][3:]
                what = f"{kind}, case {case}, rank {rank} of {nd}"
                _same_split(g, ref["splits"][case][kind], what + " vs one device")
                _same_split(g, ref["jax_splits"][case][kind], what + " vs jda_tpu")


@pytest.mark.parametrize("nd", [2, 4])
def test_ridge_sharded_bit_equal(runs, nd):
    """ridge_lbf_sharded equals the port's ridge_lbf bit for bit on every
    rank, and jda_tpu's ridge_lbf_sharded within W_REL_TOL."""
    got, ref = runs
    i = len(SPLIT_CASES[nd])
    for rank in range(nd):
        W = got[nd][rank][i]
        assert W.dtype == np.float64
        np.testing.assert_array_equal(W, ref["ridge"])
        assert w_close(ref["jax_ridge"][nd], W, W_REL_TOL)


def _train_results(runs, name):
    got, ref = runs
    i = len(SPLIT_CASES[2]) + 1 + list(TRAIN_VARIANTS).index(name)
    return [got[2][r][i] for r in range(2)], ref["train"][name]


@pytest.mark.parametrize("name", list(TRAIN_VARIANTS))
def test_trainer_mesh_equals_single_device(runs, name):
    """Trainer(mesh=) at world size 2: both ranks hold the single-device
    trainer's model in every field, W included, its live masks and its
    generator's next draw."""
    ranks, single = _train_results(runs, name)
    for r, res in enumerate(ranks):
        for f in EXACT_FIELDS + ("W",):
            np.testing.assert_array_equal(
                getattr(res["model"], f), getattr(single["model"], f),
                err_msg=f"{name}, rank {r}: {f}",
            )
        assert (res["model"].stage_idx, res["model"].cart_idx) == (1, -1)
        np.testing.assert_array_equal(res["pos_live"], single["pos_live"])
        np.testing.assert_array_equal(res["neg_live"], single["neg_live"])
        assert res["next_draw"] == single["next_draw"]
        # the fixed-point sums stay far below their 2^14 exactness bound
        assert 0 < res["max_abs_sum"] < 2.0**14
        # per node with rows 2 all-reduces (classification) or 3
        # (regression); one per descent (a cart's score updates, the
        # stage's LBF); one for the ridge
        st = res["collectives"]
        cls, reg = st["classification"]["collectives"], st["regression"]["collectives"]
        assert cls % 2 == 0 and reg % 3 == 0 and 0 < cls // 2 + reg // 3 <= len(res["stats"]["nodes"])
        assert st["descend"]["collectives"] >= 2 * res["model"].K
        assert st["ridge"]["collectives"] == 1 and st["gather"]["collectives"] == 0


def test_trainer_mesh_equals_jax(runs):
    """The single-scale mesh trainer against jda_tpu's single-device
    Trainer (which tests/test_sharded_trainer.py holds bit-equal to its
    mesh Trainer): every field but W equal, W within W_REL_TOL."""
    got, ref = runs
    ranks, _ = _train_results(runs, "single-scale")
    for res in ranks:
        assert model_diffs(ref["jax_train"], res["model"]) == []


def test_detect_batch_mesh(runs):
    """detect_batch(mesh=) at world size 2 on 3 images: every rank returns
    the boxes, scores and shapes of the port without a mesh and of
    jda_tpu's detect_batch(mesh=); under JDA_TPU_FUSED=0 the per-image
    route, with no dense0 kernel on the CPU."""
    got, ref = runs
    jres, fused, unfused = ref["detect"]
    i = len(SPLIT_CASES[2]) + 1 + len(TRAIN_VARIANTS)
    assert sum(r.n for r in fused) > 0, "degenerate case"
    for rank in range(2):
        for res, want in ((got[2][rank][i], fused), (got[2][rank][i + 1], unfused)):
            assert len(res["results"]) == len(DETECT_SIZES)
            assert res["launches"] == (0, 0)
            for a, b, j in zip(res["results"], want, jres):
                for x in (b, j):
                    np.testing.assert_array_equal(a.bboxes, x.bboxes)
                    np.testing.assert_array_equal(a.scores, x.scores)
                    np.testing.assert_array_equal(a.shapes, x.shapes)


def test_dryrun_multichip_cpu():
    """dryrun_multichip(2, device="cpu") runs its four steps on both ranks."""
    out = dryrun_multichip(2, device="cpu")
    assert [o["windows"] for o in out] == [64, 64]
    assert out[0]["boxes"] == out[1]["boxes"] and len(out[0]["boxes"]) == 3


def test_entry_matches_jax():
    """entry(device="cpu")'s forward equals __graft_entry__.entry()'s:
    score and alive bit-equal, shape within 2e-3."""
    import __graft_entry__ as G

    jfn, jargs = G.entry()
    want = {k: np.asarray(v) for k, v in jax.jit(jfn)(*jargs).items()}
    fn, args = entry(device="cpu")
    got = {k: v.numpy() for k, v in fn(*args).items()}
    assert got["score"].shape == (256,)
    np.testing.assert_array_equal(got["score"], want["score"])
    np.testing.assert_array_equal(got["alive"], want["alive"])
    np.testing.assert_allclose(got["shape"], want["shape"], atol=2e-3, rtol=0)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo group of this process alone (rank 0 of 1), torn down after."""
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0, world_size=1,
        timeout=datetime.timedelta(seconds=60),
    )
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_mesh_errors(world_of_one):
    """A 2-D mesh, a dimension other than "dp" and a device= that disagrees
    with the mesh each raise; a 1-rank "dp" mesh runs and equals no mesh."""
    from torch.distributed.device_mesh import init_device_mesh

    from jda_tpu_torch.train.boost import Trainer
    from jda_tpu_torch.train.sharded import ShardedOps

    c = port_config(_tiny_config(**ONE_STAGE))
    flat = init_device_mesh("cpu", (1, 1), mesh_dim_names=("dp", "tp"))
    other = init_device_mesh("cpu", (1,), mesh_dim_names=("tp",))
    dp = init_device_mesh("cpu", (1,), mesh_dim_names=("dp",))
    m, imgs = _detect_case()
    det = Detector(TP.from_arrays(dataclasses.asdict(m)), device="cpu")
    for bad in (flat, other):
        with pytest.raises(ValueError, match='"dp"'):
            Trainer(c, mesh=bad, device="cpu")
        with pytest.raises(ValueError, match='"dp"'):
            ShardedOps(bad)
        with pytest.raises(ValueError, match='"dp"'):
            det.detect_batch(imgs, mesh=bad)
    with pytest.raises(ValueError, match="disagrees"):
        Trainer(c, mesh=dp, device="cuda")
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(c, mesh=object(), device="cpu")
    assert Trainer(c, mesh=dp, device="cpu").device.type == "cpu"
    for a, b in zip(det.detect_batch(imgs, mesh=dp, **DETECT_KW),
                    det.detect_batch(imgs, **DETECT_KW)):
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        np.testing.assert_array_equal(a.scores, b.scores)
