"""The port's device miner against jda_tpu's on the CPU: window
enumeration, the on-device crop+resize screen, and end-to-end mining with
a partial cascade of a model the packages share."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jda_tpu.data as JD
import jda_tpu.params as JP
from jda_tpu.train import mining as JM
from jda_tpu.train.boost import Trainer as JaxTrainer
import jda_tpu_torch.data as PD
from jda_tpu_torch import params as PP
from jda_tpu_torch.train import mining as PM
from jda_tpu_torch.train.boost import Trainer

from test_training import _tiny_config
from torch_train_util import port_config, one_torch_thread  # noqa: F401 (fixture)


def _bgs(n=12, size=160, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bg = rng.integers(50, 210, (size, size + 13 * (_ % 3))).astype(np.int32)
        for _ in range(40):
            x, y = rng.integers(2, size - 4, 2)
            bg[y : y + 3, x : x + 3] = 25
        out.append(np.clip(bg, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("w,size", [(32, 32), (45, 32), (45, 24), (77, 16), (200, 32)])
def test_bilinear_taps_match_jax(w, size):
    for a, b in zip(PM._bilinear_taps(w, size), JM._bilinear_taps(w, size)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_collect_matches_jax():
    """Window groups per state equal jda_tpu's DeviceMiner's, batch after
    batch (the pushback across a background or window-size change)."""
    c = _tiny_config()
    bgs = _bgs()
    gj, gp = JD.NegGenerator(c), PD.NegGenerator(port_config(c))
    gj.load_images(bgs, np.random.default_rng(5))
    gp.load_images(bgs, np.random.default_rng(5))
    mj = JM.DeviceMiner(gj, c, per_state=64)
    mp = PM.DeviceMiner(gp, port_config(c), per_state=64, device="cpu")
    for _ in range(8):
        for a, b in zip(mj._collect(), mp._collect()):
            assert (a["sid"], a["n"], a["w"], a["ver"]) == (b["sid"], b["n"], b["w"], b["ver"])
            np.testing.assert_array_equal(a["ys"], b["ys"])
            np.testing.assert_array_equal(a["xs"], b["xs"])
            np.testing.assert_array_equal(a["bg"], b["bg"])


@pytest.mark.parametrize("multi", [False, True], ids=["single-scale", "multi-scale"])
def test_synth_matches_jax_and_cv2(multi):
    """The screen's pixels: a gather and a two-tap float32 blend per axis
    against jda_tpu's one-hot matmuls.  Both are within 1 of cv2.resize;
    the share of pixels where they differ is printed and bounded (the
    matmul may fuse a product into its sum, the blend rounds each)."""
    import cv2

    c = _tiny_config(multi_scale=multi)
    g = JD.NegGenerator(c)
    g.load_images(_bgs(), np.random.default_rng(5))
    mj = JM.DeviceMiner(g, c, per_state=96)
    groups = mj._collect()
    mj._ensure_bgs(groups)
    H, W = mj._hw
    S, P = g.n_states, mj.P
    sizes = (c.img_o_size, c.img_h_size, c.img_q_size) if multi else (c.img_o_size,)
    ssum = sum(sizes)
    D = sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))
    b = S * P
    ipack = np.zeros((S, 3 * P + 2 * ssum), np.int32)
    fpack = np.zeros(2 * S * ssum + 2 * b, np.float32)
    shift = np.random.default_rng(3).uniform(-0.05, 0.05, (b, 2)).astype(np.float32)
    fpack[2 * S * ssum :] = shift.reshape(-1)
    taps = {}
    for gr in groups:
        sid = gr["sid"]
        ipack[sid, :P] = gr["ys"]
        ipack[sid, P : 2 * P] = gr["xs"]
        col, fb = 2 * P, 0
        for sz in sizes:
            a, b_, c0, c1 = JM._bilinear_taps(gr["w"], sz)
            ipack[sid, col : col + sz] = a
            ipack[sid, col + sz : col + 2 * sz] = b_
            col += 2 * sz
            fpack[fb + sid * sz : fb + (sid + 1) * sz] = c0
            fpack[fb + S * sz + sid * sz : fb + S * sz + (sid + 1) * sz] = c1
            fb += 2 * S * sz
            taps.setdefault(sz, []).append((a, b_, c0, c1))
        ipack[sid, col : col + gr["n"]] = 1
    ms = np.random.default_rng(4).uniform(0.2, 0.8, c.landmark_dim).astype(np.float32)
    jflat, jshapes, jvalid = JM._make_synth(S, P, H, W, sizes, D)(
        mj._bgs_dev, jnp.asarray(ipack), jnp.asarray(fpack), jnp.asarray(ms)
    )
    jflat = np.asarray(jflat).reshape(b, D)

    bgs = np.zeros((S, H, W), np.uint8)
    for gr in groups:
        bgs[gr["sid"], : gr["bg"].shape[0], : gr["bg"].shape[1]] = gr["bg"]
    ptaps = {
        sz: tuple(torch.from_numpy(np.stack(x).astype(np.int64 if i < 2 else np.float32))
                  for i, x in enumerate(zip(*per)))
        for sz, per in taps.items()
    }
    valid = np.arange(P)[None] < np.asarray([gr["n"] for gr in groups])[:, None]
    pflat, pshapes, pvalid = PM._make_synth(sizes, D)(
        torch.from_numpy(bgs),
        torch.from_numpy(np.stack([gr["ys"] for gr in groups]).astype(np.int64)),
        torch.from_numpy(np.stack([gr["xs"] for gr in groups]).astype(np.int64)),
        ptaps,
        torch.from_numpy(valid),
        torch.from_numpy(shift),
        torch.from_numpy(ms),
    )
    pflat = pflat.numpy().reshape(b, D)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(pshapes.numpy(), np.asarray(jshapes))
    v = valid.reshape(-1)
    diff = pflat[v].astype(np.int32) - jflat[v]
    assert np.abs(diff).max() <= 1
    share = float((diff == 0).mean())
    print(f"screen pixels equal to jda_tpu's: {share}")
    assert share >= 0.999
    # every synthesized patch within 1 of OpenCV
    nd = 0
    for gr in groups:
        for p in range(gr["n"]):
            y, x, w = int(gr["ys"][p]), int(gr["xs"][p]), gr["w"]
            off = 0
            for sz in sizes:
                ref = cv2.resize(gr["bg"][y : y + w, x : x + w], (sz, sz)).astype(np.int32)
                got = pflat[gr["sid"] * P + p, off : off + sz * sz].reshape(sz, sz)
                nd = max(nd, int(np.abs(ref - got).max()))
                off += sz * sz
    assert nd <= 1


def test_crop_rows_equal_patch_row():
    c = port_config(_tiny_config())
    rng = np.random.default_rng(6)
    bg = rng.integers(0, 256, (120, 140)).astype(np.uint8)
    acc = [(bg, int(rng.integers(0, 40)), int(rng.integers(0, 40)), int(w), None)
           for w in rng.choice([32, 38, 57, 80], 25)]
    want = np.stack([PD.patch_row(bg[y : y + w, x : x + w], c) for bg, y, x, w, _ in acc])
    np.testing.assert_array_equal(PM._crop_rows(acc, c), want)


@pytest.fixture(scope="module")
def mined():
    """Both device miners with the validator of a shared model (stage 0
    whole, with its regression, and 6 carts of stage 1) over the same
    backgrounds and generator seeds."""
    c = _tiny_config()
    jm = JP.synthetic_model(T=2, K=c.K, landmark_n=c.landmark_n, seed=3, reject_rate=0.12)
    pm = PP.from_arrays(dataclasses.asdict(jm))
    bgs = _bgs(seed=1)
    out = []
    for tr in (JaxTrainer(c, model=jm), Trainer(port_config(c), model=pm, device="cpu")):
        tr.neg_gen.load_images(bgs, np.random.default_rng(11))
        v = tr.make_validator(1, 5)
        if isinstance(tr, JaxTrainer):
            miner = JM.DeviceMiner(tr.neg_gen, c, per_state=128)
        else:
            miner = PM.DeviceMiner(tr.neg_gen, tr.c, per_state=128, device="cpu")
        rng = np.random.default_rng(4)
        out.append((miner.generate(v, 150, max_batches=12, rng=rng), rng, tr, v))
    return out


def test_device_mining_rows_equal(mined):
    """The same stored rows, scores and shapes, and the same draws from the
    generator (the padded batch's shifts)."""
    (rj, sj, shj, stj), rngj, _, _ = mined[0]
    (rp, sp, shp, stp), rngp, _, _ = mined[1]
    assert 0 < len(rp)
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(shp, shj)
    assert rngj.integers(1 << 62) == rngp.integers(1 << 62)


def test_device_mining_stats_equal(mined):
    """Screen statistics equal: every screened verdict agreed."""
    (_, _, _, stj), _, _, _ = mined[0]
    (_, _, _, stp), _, _, _ = mined[1]
    for k in ("exhausted", "not_hard", "avg_reject_carts", "fp_rate", "bg_used"):
        assert stp[k] == stj[k], k
    assert stp["screened"] > stp["not_hard"] > 0
    assert stp["screen_s"] > 0 and stp["revalidate_s"] > 0


def test_validator_matches_jax(mined):
    """make_validator on fixed rows and shifts: alive, score, shape and
    visit counts of rejected windows equal (visits of the survivors differ
    by the no-op carts the JAX package pads the partial stage with)."""
    _, _, jtr, jv = mined[0]
    _, _, ptr, pv = mined[1]
    rng = np.random.default_rng(21)
    rows = rng.integers(0, 256, (300, ptr.pos.D)).astype(np.uint8)
    shift = rng.uniform(-0.05, 0.05, (300, 2))
    aj, sj, shj, nj = jv(rows, shift=shift)
    ap, sp, shp, np_ = pv(rows, shift=shift)
    np.testing.assert_array_equal(ap, aj)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(shp, shj)
    np.testing.assert_array_equal(np_[~ap], nj[~aj])
    assert (~ap).any() and ap.any()


def test_host_path_through_trainer(monkeypatch):
    """JDA_TPU_DEVICE_MINER=0 (read at call time): more_neg_samples mines
    through NegGenerator.generate in both packages, with the same rows."""
    monkeypatch.setenv("JDA_TPU_DEVICE_MINER", "0")
    c = _tiny_config()
    jm = JP.synthetic_model(T=2, K=c.K, landmark_n=c.landmark_n, seed=5, reject_rate=0.05)
    pm = PP.from_arrays(dataclasses.asdict(jm))
    rows = np.random.default_rng(1).integers(0, 256, (40, 32 * 32 + 24 * 24 + 16 * 16))
    gts = np.tile(jm.mean_shape, (40, 1))
    out = []
    for tr in (JaxTrainer(c, model=jm), Trainer(port_config(c), model=pm, device="cpu")):
        tr.mining_batch = 128
        tr.mining_max_batches = 4
        tr.set_synthetic_data(rows.astype(np.uint8), gts, _bgs(n=4, seed=2))
        tr.model.mean_shape = jm.mean_shape.copy()
        assert tr.more_neg_samples(0, 3) > 0
        out.append(tr)
    a, b = out
    assert b.stats["mining"][0]["device_miner"] is False
    np.testing.assert_array_equal(b.neg.imgs, a.neg.imgs)
    np.testing.assert_array_equal(b.neg.scores, a.neg.scores)
    np.testing.assert_array_equal(b.neg.current_shapes, a.neg.current_shapes)
