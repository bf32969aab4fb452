"""jda_tpu_torch.ops.cascade against jda_tpu.ops.cascade on the CPU.

Exact mode replays the same float32 op sequence, so leaves, alive and nvis
are equal and score and shape are bit-equal.  The one-hot regression sums
the weight rows in another order (one matmul), so it is held to 1e-6: the
shapes are O(1) and the K*leaf_n products are exact one-hot selections, so
only the summation order differs, a few float32 ulps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.ops import cascade as JC
from jda_tpu_torch import params as TP
from jda_tpu_torch.ops import cascade as TC

T, K, L = 3, 22, 9
H, W = 72, 88
N = 400


@pytest.fixture(scope="module")
def setup():
    m = JP.synthetic_model(T=T, K=K, landmark_n=L, seed=17, reject_rate=0.15)
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (H * W,)).astype(np.uint8)
    win = rng.choice(np.array([24, 30, 37], np.int32), N)
    xs = (rng.random(N) * (W - win)).astype(np.int32)
    ys = (rng.random(N) * (H - win)).astype(np.int32)
    geom = {
        "base": np.stack([ys * W + xs] * 3, 1).astype(np.int32),
        "stride": np.full((N, 3), W, np.int32),
        "pw": np.stack([win] * 3, 1),
    }
    return m, TP.from_arrays(dataclasses.asdict(m)), img, geom


def _states(setup):
    m, tm, img, g = setup
    dev = m.device_arrays(np.float32)
    tdev = tm.device_tensors("cpu")
    valid = np.ones(N, bool)
    valid[::7] = False
    js = JC.init_state(
        N, dev["mean_shape"], *(jnp.asarray(g[k]) for k in ("base", "stride", "pw", "pw")),
        jnp.asarray(valid),
    )
    ts = TC.init_state(
        N, tdev["mean_shape"], *(torch.from_numpy(g[k]) for k in ("base", "stride", "pw", "pw")),
        torch.from_numpy(valid),
    )
    return dev, tdev, js, ts


@pytest.mark.parametrize("rounding", [False, True], ids=["trunc", "round"])
def test_cascade_full_exact_bit_equal(setup, rounding):
    m, tm, img, g = setup
    dev, tdev, js, ts = _states(setup)
    jout = JC.cascade_full(
        dev, jnp.asarray(img.astype(np.int32)), js, depth=4, rounding=rounding,
        leaf_n=m.leaf_n, T=T, exact=True, single_scale=True,
    )
    tout = TC.cascade_full(
        tdev, torch.from_numpy(img), ts, depth=4, rounding=rounding,
        leaf_n=m.leaf_n, T=T, exact=True, single_scale=True,
    )
    alive = np.asarray(jout["alive"])
    assert 0 < alive.sum() < N, "degenerate fixture"
    for k in ("score", "alive", "nvis", "shape"):
        a, b = np.asarray(jout[k]), tout[k].numpy()
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_stage_leaves_equal(setup):
    """Leaves of one full stage chunk, and the multi-scale descent path
    (per-node pyramid level) on a 3-level geometry."""
    m, tm, img, g = setup
    dev, tdev, js, ts = _states(setup)
    jst, jl = JC.run_cart_chunk(
        JC.stage_params(dev, 1), jnp.asarray(img.astype(np.int32)), js,
        depth=4, rounding=False, single_scale=True,
    )
    tst, tl = TC.run_cart_chunk(
        TC.stage_params(tdev, 1), torch.from_numpy(img), ts,
        depth=4, rounding=False, single_scale=True,
    )
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    for k in ("score", "alive", "nvis"):
        np.testing.assert_array_equal(np.asarray(jst[k]), tst[k].numpy())

    ms = JP.synthetic_model(T=1, K=K, landmark_n=L, seed=3, multi_scale=True)
    tms = TP.from_arrays(dataclasses.asdict(ms))
    dev, tdev = ms.device_arrays(np.float32), tms.device_tensors("cpu")
    rng = np.random.default_rng(5)
    lvl_w = np.array([24, 17, 12], np.int32)  # o/h/q patch widths per level
    offs = np.array([0, H * W // 3, 2 * H * W // 3], np.int32)
    base = offs[None, :] + rng.integers(0, 40, (N, 3)).astype(np.int32)
    stride = np.full((N, 3), W // 2, np.int32)
    pw = np.broadcast_to(lvl_w, (N, 3)).copy()
    valid = np.ones(N, bool)
    js = JC.init_state(N, dev["mean_shape"], jnp.asarray(base), jnp.asarray(stride),
                       jnp.asarray(pw), jnp.asarray(pw), jnp.asarray(valid))
    ts = TC.init_state(N, tdev["mean_shape"], torch.from_numpy(base),
                       torch.from_numpy(stride), torch.from_numpy(pw),
                       torch.from_numpy(pw), torch.from_numpy(valid))
    jl, jb = JC.carts_descend(JC.stage_params(dev, 0), jnp.asarray(img.astype(np.int32)),
                              js, depth=4, rounding=True)
    tl, tb = TC.carts_descend(TC.stage_params(tdev, 0), torch.from_numpy(img), ts,
                              depth=4, rounding=True)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def test_onehot_regression_within_1e6(setup):
    m, tm, img, g = setup
    dev, tdev, js, ts = _states(setup)
    leaves = np.random.default_rng(8).integers(0, m.leaf_n, (N, K)).astype(np.int32)
    jout = JC.apply_regression(dev["W"][0], jnp.asarray(leaves), js,
                               leaf_n=m.leaf_n, exact=False)
    tout = TC.apply_regression(tdev["W"][0], torch.from_numpy(leaves), ts,
                               leaf_n=m.leaf_n, exact=False)
    np.testing.assert_allclose(tout["shape"].numpy(), np.asarray(jout["shape"]),
                               rtol=0, atol=1e-6)
    texact = TC.apply_regression(tdev["W"][0], torch.from_numpy(leaves), ts,
                                 leaf_n=m.leaf_n, exact=True)
    jexact = JC.apply_regression(dev["W"][0], jnp.asarray(leaves), js,
                                 leaf_n=m.leaf_n, exact=True)
    np.testing.assert_array_equal(texact["shape"].numpy(), np.asarray(jexact["shape"]))
    # rejected windows keep their shape
    dead = ~ts["alive"].numpy()
    np.testing.assert_array_equal(tout["shape"].numpy()[dead], ts["shape"].numpy()[dead])


def test_int_conversions_match():
    x = np.array([-2.5, -1.5, -0.5, -0.49, 0.0, 0.5, 1.5, 2.49, 2.5, 7.99, -7.99],
                 np.float32)
    for jf, tf in ((JC.trunc_toward_zero, TC.trunc_toward_zero),
                   (JC.round_half_away, TC.round_half_away)):
        np.testing.assert_array_equal(np.asarray(jf(jnp.asarray(x))),
                                      tf(torch.from_numpy(x)).numpy())


def test_take_fill_matches_jnp_take():
    """Reads past the stacked pyramid's end (the half and quarter patches of
    a multi-scale model near the bottom edge): the int32 minimum, as
    jnp.take gives on the JAX package's int32 pixels, and a pixel
    difference that wraps in int32 the same way."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, 500).astype(np.uint8)
    idx1 = rng.integers(0, 700, (40, 6))
    idx2 = rng.integers(0, 700, (40, 6))
    jimg = jnp.asarray(img.astype(np.int32))
    jv = jnp.take(jimg, jnp.asarray(idx1)) - jnp.take(jimg, jnp.asarray(idx2))
    timg = torch.from_numpy(img)
    t1 = TC.take_fill(timg, torch.from_numpy(idx1))
    tv = t1 - TC.take_fill(timg, torch.from_numpy(idx2))
    assert (idx1 >= 500).any() and t1.dtype == torch.int32
    np.testing.assert_array_equal(t1.numpy()[idx1 >= 500], np.iinfo(np.int32).min)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
