"""The port's training stack against jda_tpu on the CPU: split search,
feature values, the ridge regression and a one-stage training run, on the
same inputs and seeds."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jda_tpu.train import features as JFT
from jda_tpu.train import regression as JRG
from jda_tpu.train import split as JSP
from jda_tpu_torch.train import features as FT
from jda_tpu_torch.train import regression as RG
from jda_tpu_torch.train import split as SP

from test_training import _tiny_config, build_synthetic
from torch_train_util import W_REL_TOL, model_diffs, train_both, w_close, one_torch_thread  # noqa: F401 (fixture)


def _weights(rng, m_pos, m_neg):
    """Boosting weights as the trainer makes them: jointly normalised and
    quantized to 2^-23 (DataSet.update_weights)."""
    w = rng.uniform(0.1, 1.0, m_pos + m_neg)
    w = np.round(w / w.sum() * 2.0**23) / 2.0**23
    return w[:m_pos].astype(np.float32), w[m_pos:].astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_classification_split_matches_jax(seed):
    rng = np.random.default_rng(seed)
    Mp, Mn, F = 90, 130, 40
    spread = (20, 60, 255, 3)[seed]
    vp = rng.integers(-spread, spread + 1, (Mp, F)).astype(np.int32)
    vn = (rng.integers(-spread, spread + 1, (Mn, F)) + seed).clip(-255, 255).astype(np.int32)
    wp, wn = _weights(rng, Mp, Mn)
    valid_p = rng.uniform(size=Mp) > 0.1
    valid_n = rng.uniform(size=Mn) > 0.1
    wp, wn = np.where(valid_p, wp, 0).astype(np.float32), np.where(valid_n, wn, 0).astype(np.float32)
    fj, thj, ej = JSP.classification_split(
        jnp.asarray(vp), jnp.asarray(wp), jnp.asarray(valid_p),
        jnp.asarray(vn), jnp.asarray(wn), jnp.asarray(valid_n),
    )
    f, th, e = SP.classification_split(
        _t(vp), _t(wp), _t(valid_p), _t(vn), _t(wn), _t(valid_n)
    )
    assert (int(f), int(th)) == (int(fj), int(thj))
    assert float(e) == float(ej)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_regression_split_matches_jax(seed):
    rng = np.random.default_rng(10 + seed)
    Mp, F = 150, 50
    vp = rng.integers(-30, 31, (Mp, F)).astype(np.int32)
    resid = rng.normal(0, 0.1, (Mp, 2)).astype(np.float32)
    has_gt = rng.uniform(size=Mp) > 0.1
    valid = rng.uniform(size=Mp) > 0.05 * seed
    u = rng.uniform(0.1, 0.9, F).astype(np.float32)
    fj, thj, mj = JSP.regression_split(
        jnp.asarray(vp), jnp.asarray(resid), jnp.asarray(has_gt),
        jnp.asarray(valid), jnp.asarray(u),
    )
    f, th, m = SP.regression_split(_t(vp), _t(resid), _t(has_gt), _t(valid), _t(u))
    assert (int(f), int(th)) == (int(fj), int(thj))
    assert float(m) == float(mj)


def test_split_of_empty_side():
    """No valid positives: the regression split sends everything right
    (feature 0, threshold -256), as in jda_tpu."""
    vp = np.zeros((0, 5), np.int32)
    f, th, _ = SP.regression_split(
        _t(vp), torch.zeros((0, 2)), torch.zeros(0, dtype=torch.bool),
        torch.zeros(0, dtype=torch.bool), torch.full((5,), 0.5),
    )
    assert (int(f), int(th)) == (0, -256)


def test_quantize_metric_matches_jax():
    rng = np.random.default_rng(4)
    x = np.concatenate(
        [rng.normal(0, 3, 500), [0.0, -0.0, np.inf, -np.inf, 1e-30]]
    ).astype(np.float32)
    want = np.asarray(JSP._quantize_metric(jnp.asarray(x)))
    np.testing.assert_array_equal(SP._quantize_metric(_t(x)).numpy(), want)


@pytest.mark.parametrize("multi_scale", [False, True], ids=["single-scale", "multi-scale"])
@pytest.mark.parametrize("with_stp", [False, True], ids=["no-st", "st"])
def test_feature_values_match_jax(multi_scale, with_stp):
    """feature_values (flat buffer, any pool) and feature_values_mxu (the
    [M, S, S] canvas, single-scale pools) give jda_tpu's int32 values."""
    c = _tiny_config()
    rng = np.random.default_rng(5)
    dims = (c.img_o_size, c.img_h_size, c.img_q_size)
    D = sum(d * d for d in dims)
    M = 70
    rows = rng.integers(0, 256, (M, D)).astype(np.uint8)
    shapes = (rng.uniform(0.2, 0.8, (M, 2 * c.landmark_n))).astype(np.float32)
    pool = JFT.gen_feature_pool(np.random.default_rng(6), 90, c.landmark_n, 0.3, multi_scale)
    stp = None
    if with_stp:
        ang = rng.uniform(-0.4, 0.4, M)
        sc = rng.uniform(0.8, 1.25, M)
        stp = np.stack(
            [np.stack([sc * np.cos(ang), -sc * np.sin(ang)], 1),
             np.stack([sc * np.sin(ang), sc * np.cos(ang)], 1)], 1
        ).astype(np.float32)
    geom = JFT.corpus_geometry(M, dims)
    want = np.asarray(
        JFT.feature_values(
            jnp.asarray(rows.reshape(-1).astype(np.int32)),
            {k: jnp.asarray(v) for k, v in geom.items()},
            jnp.asarray(shapes), pool.device(),
            None if stp is None else jnp.asarray(stp),
        )
    )
    ppool = FT.FeaturePool(pool.scale, pool.lmk1, pool.lmk2, pool.off1, pool.off2).device("cpu")
    pgeom = {k: _t(v) for k, v in FT.corpus_geometry(M, dims).items()}
    pstp = None if stp is None else _t(stp)
    got = FT.feature_values(_t(rows.reshape(-1)), pgeom, _t(shapes), ppool, pstp)
    np.testing.assert_array_equal(got.numpy(), want)
    if not multi_scale:
        S = c.img_o_size
        canvas = rows[:, : S * S].reshape(M, S, S)
        want_mxu = np.asarray(
            JFT.feature_values_mxu(
                jnp.asarray((canvas.astype(np.int16) - 128).astype(np.int8)),
                jnp.asarray(shapes), pool.device(),
                None if stp is None else jnp.asarray(stp),
            )
        )
        got_mxu = FT.feature_values_mxu(_t(canvas), _t(shapes), ppool, pstp)
        np.testing.assert_array_equal(got_mxu.numpy(), want_mxu)
        np.testing.assert_array_equal(got_mxu.numpy(), want)


def test_gen_feature_pool_draws_like_jax():
    a = JFT.gen_feature_pool(np.random.default_rng(7), 50, 27, 0.2, True)
    b = FT.gen_feature_pool(np.random.default_rng(7), 50, 27, 0.2, True)
    for f in ("scale", "lmk1", "lmk2", "off1", "off2"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("n", [300, 1100])
def test_ridge_lbf_within_tolerance(n):
    """Normal equations exact in float32, Cholesky within W_REL_TOL; the
    second case crosses a chunk boundary (chunk=512)."""
    rng = np.random.default_rng(n)
    K, leaf_n, L2 = 24, 8, 10
    leaves = rng.integers(0, leaf_n, (n, K)) + np.arange(K)[None] * leaf_n
    resid = rng.normal(0, 0.05, (n, L2))
    want = JRG.ridge_lbf(leaves.astype(np.int32), resid, K * leaf_n, chunk=512)
    got = RG.ridge_lbf(leaves, resid, K * leaf_n, chunk=512, device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    assert w_close(want, got, W_REL_TOL), np.abs(want - got).max()


# ---------------------------------------------------------------------------
# one stage, end to end
# ---------------------------------------------------------------------------

ONE_STAGE = dict(T=1, K=8, feats=(40,), radius=(0.3,), probs=(0.8,),
                 recall=(0.99,), drops=(1,), nps=(1.0,),
                 score_normalization_steps=(2,), mining_th=(0.5,),
                 restart_th=(0.001,))


@pytest.fixture(scope="module")
def one_stage():
    """A T=1 `_tiny_config` run through both trainers (device miner on)."""
    c = _tiny_config(**ONE_STAGE)
    rows, gts, bgs = build_synthetic(c, n_pos=120)
    return train_both(c, rows, gts, bgs, mining_max_batches=20)


def test_one_stage_model_equal(one_stage):
    """Every model field but W bit-equal, W within tolerance."""
    a, b = one_stage
    assert model_diffs(a.model, b.model) == []
    assert (b.model.stage_idx, b.model.cart_idx) == (1, -1)


def test_one_stage_corpus_equal(one_stage):
    """Live masks, weights, scores and the mined rows equal."""
    a, b = one_stage
    for ds_a, ds_b in ((a.pos, b.pos), (a.neg, b.neg)):
        np.testing.assert_array_equal(ds_a.live, ds_b.live)
        np.testing.assert_array_equal(ds_a.weights, ds_b.weights)
        np.testing.assert_array_equal(ds_a.scores, ds_b.scores)
        np.testing.assert_array_equal(ds_a.imgs, ds_b.imgs)
    assert len(b.neg.imgs) > 0


def test_one_stage_random_stream_equal(one_stage):
    """Both trainers consumed the same draws from their generators."""
    a, b = one_stage
    assert a.rng.integers(1 << 62) == b.rng.integers(1 << 62)


def test_one_stage_learns(one_stage):
    """The JAX package's own assertions on this config
    (tests/test_training.py::test_training_variant_paths)."""
    from jda_tpu_torch.utils import calc_mean_error

    _, b = one_stage
    st = b.stats["stages"][0]
    assert b.pos.size > 60
    assert st["mean_error"] < st["mean_error_before"]
    pl = b.pos.live_idx()
    err = calc_mean_error(b.pos.gt_shapes[pl], b.pos.current_shapes[pl],
                          b.c.left_pupils, b.c.right_pupils)
    assert err < st["mean_error_before"]
    assert len(b.stats["carts"]) == b.c.K and len(b.stats["mining"]) >= 1
