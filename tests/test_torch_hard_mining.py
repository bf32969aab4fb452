"""The port's hard-pool miners against jda_tpu's on the CPU: the canvas
miner's tap and geometry helpers, its window sampler, its screen's pixels,
`CanvasHardMiner.generate`, the hard factory's difficulty ladder
(`NegGenerator.generate_hard`), the three top-up branches of
`Trainer.more_neg_samples`, a two-stage training run with both factories
registered, and `CascadeParams.describe_cart`.

Every comparison is bit-equal unless its test says otherwise: the same
seeds through both packages, the port on the CPU."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import jda_tpu.data as JD
import jda_tpu.params as JP
from jda_tpu.train import mining as JM
from jda_tpu.train.boost import Trainer as JaxTrainer
from jda_tpu.train.boost import empty_model as j_empty_model
import jda_tpu_torch.data as PD
import jda_tpu_torch.params as PP
from jda_tpu_torch.train import mining as PM
from jda_tpu_torch.train.boost import Trainer

from test_training import _tiny_config, build_synthetic
from torch_train_util import (  # noqa: F401 (one_torch_thread: a fixture)
    model_diffs, one_torch_thread, port_config, split_share, train_both,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _canvas_factory(c):
    """Deterministic test canvases: a bright 'face' square inside clutter;
    odd indices are off-manifold (any_window) canvases
    (tests/test_mining.py's factory)."""

    def factory(i, d=0.0):
        rng = np.random.default_rng(1000 + i)
        R = int(rng.integers(c.img_o_size, 2 * c.img_o_size))
        C = 3 * R
        canvas = rng.integers(40, 200, (C, C)).astype(np.uint8)
        canvas[R : 2 * R, R : 2 * R] = rng.integers(150, 255, (R, R))
        return canvas, (R, R, R), bool(i % 2)

    return factory


def _hard_factory(c):
    """A two-argument (adaptive) hard factory: noise patches whose contrast
    falls with the difficulty."""

    def factory(i, d):
        rng = np.random.default_rng(50_000 + i)
        spread = max(8, int(120 * (1.0 - 0.4 * d)))
        return rng.integers(128 - spread, 128 + spread, (c.img_o_size, c.img_o_size)).astype(np.uint8)

    return factory


def _register(tr, c):
    tr.neg_gen.load_hard_factory(_hard_factory(c))
    tr.neg_gen.load_canvas_factory(_canvas_factory(c))


def _gen_state(g):
    return (g._hard_difficulty, g._hard_cursor, g._canvas_cursor)


# ---------------------------------------------------------------------------
# helpers and geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w,size", [(24, 32), (32, 32), (45, 32), (77, 48), (200, 16)])
def test_canvas_helpers_match_jax(w, size):
    """_trunc_taps, _trunc_then_bilinear_taps (to the h and q sizes of an
    o = size patch), _box_iou_vec and _subsample equal jda_tpu's."""
    for a, b in zip(PM._trunc_taps(w, size), JM._trunc_taps(w, size)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for sz in (size * 3 // 4, size // 2):
        for a, b in zip(PM._trunc_then_bilinear_taps(w, size, sz),
                        JM._trunc_then_bilinear_taps(w, size, sz)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(w * 100 + size)
    x0, y0 = rng.integers(0, 3 * w, (2, 64))
    np.testing.assert_array_equal(
        PM._box_iou_vec(x0, y0, w, w, w, size), JM._box_iou_vec(x0, y0, w, w, w, size)
    )
    canvas = rng.integers(0, 256, (3 * w, 3 * w)).astype(np.uint8)
    for x, y in rng.integers(0, 2 * w, (4, 2)):
        np.testing.assert_array_equal(
            PM._subsample(canvas, int(x), int(y), w, size),
            JM._subsample(canvas, int(x), int(y), w, size),
        )


def _miners(c, n_slots, per_slot):
    """Both packages' canvas miners over fresh generators with the test
    canvas factory."""
    gj, gp = JD.NegGenerator(c), PD.NegGenerator(port_config(c))
    gj.load_canvas_factory(_canvas_factory(c))
    gp.load_canvas_factory(_canvas_factory(c))
    mj = JM.CanvasHardMiner(gj, c, n_slots=n_slots, per_slot=per_slot)
    mp = PM.CanvasHardMiner(gp, port_config(c), n_slots=n_slots, per_slot=per_slot,
                            device="cpu")
    return mj, mp


@pytest.mark.parametrize("difficulty", [0.0, 1.4])
def test_sample_windows_match_jax(difficulty):
    """The same slots and rng give the same (w, ys, xs, n); boundary slots
    emit only windows with IoU in [lo(difficulty), 0.48] against the face
    box, registered slots overlap the face (test_canvas_window_geometry)."""
    c = _tiny_config()
    mj, mp = _miners(c, 6, 64)
    for m in (mj, mp):
        m.gen._hard_difficulty = difficulty
        m._refresh(6)
    rj, rp = np.random.default_rng(0), np.random.default_rng(0)
    lo = min(0.22 + 0.20 * difficulty, 0.44)
    for sj, sp in zip(mj.slots, mp.slots):
        w, ys, xs, n = mp._sample_windows(sp, rp)
        wj, ysj, xsj, nj = mj._sample_windows(sj, rj)
        assert (w, n) == (wj, nj)
        np.testing.assert_array_equal(ys, ysj)
        np.testing.assert_array_equal(xs, xsj)
        assert n > 0
        C = sp["canvas"].shape[0]
        assert (xs[:n] >= 0).all() and (xs[:n] + w <= C).all()
        assert (ys[:n] >= 0).all() and (ys[:n] + w <= C).all()
        iou = PM._box_iou_vec(xs[:n].astype(np.float64), ys[:n].astype(np.float64), w,
                              sp["fx"], sp["fy"], sp["fs"])
        if sp["any"]:
            assert (iou > 0.3).all()
        else:
            assert (iou >= lo - 1e-9).all() and (iou <= 0.48 + 1e-9).all()
    assert rj.integers(1 << 62) == rp.integers(1 << 62)


def test_resident_canvases_grow_and_update():
    """The resident buffer takes the largest canvas's true size, grows when
    a refresh brings a larger canvas, and re-uploads only the slots whose
    canvas changed; every slot holds its canvas top-left, zeros after."""
    c = port_config(_tiny_config())
    sizes = iter([60, 90, 75, 48, 120])

    def factory(i, d):
        C = next(sizes)
        return np.full((C, C), i + 1, np.uint8), (C // 3, C // 3, C // 3), False

    g = PD.NegGenerator(c)
    g.load_canvas_factory(factory)
    m = PM.CanvasHardMiner(g, c, n_slots=3, per_slot=8, device="cpu")

    def check(side):
        buf = m._canv_dev.numpy()
        assert buf.shape == (3, side, side)
        for sid, s in enumerate(m.slots):
            C = s["canvas"].shape[0]
            np.testing.assert_array_equal(buf[sid, :C, :C], s["canvas"])
            assert not buf[sid, C:].any() and not buf[sid, :, C:].any()

    m._refresh(3)
    m._ensure_dev()
    check(90)
    first = m._canv_dev
    m._refresh(1)  # slot 0: a 48 canvas, the buffer keeps its size
    m._ensure_dev()
    assert m._canv_dev is first
    check(90)
    m._refresh(1)  # slot 1: a 120 canvas, the buffer grows
    m._ensure_dev()
    check(120)
    assert m._slot_ver == m._ver


@pytest.mark.parametrize("multi", [False, True], ids=["single-scale", "multi-scale"])
def test_truncation_synth_matches_subsample_and_jax(multi):
    """The port's synth with truncation taps: the o plane equals the host
    `_subsample` and jda_tpu's synth bit for bit (the blend with wf0 = 1,
    wf1 = 0 gives the source pixel exactly).  Multi-scale h/q planes go
    through the float blend of the trunc-then-bilinear taps: within 1 of
    jda_tpu's one-hot matmuls, with the share of equal pixels printed and
    bounded (where they differ a screen verdict could flip; stored rows
    never depend on them)."""
    c = _tiny_config(multi_scale=multi)
    mj, mp = _miners(c, 4, 24)
    mj._refresh(4)
    mp._refresh(4)
    mj._ensure_dev()
    mp._ensure_dev()
    o = c.img_o_size
    sizes = (o, c.img_h_size, c.img_q_size) if multi else (o,)
    ssum = sum(sizes)
    D = sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))
    S, P = mj.S, mj.P
    b = S * P
    rng = np.random.default_rng(3)
    meta = [mp._sample_windows(s, rng) for s in mp.slots]
    ipack = np.zeros((S, 3 * P + 2 * ssum), np.int32)
    fpack = np.zeros(2 * S * ssum + 2 * b, np.float32)
    shift = np.random.default_rng(4).uniform(-0.05, 0.05, (b, 2)).astype(np.float32)
    fpack[2 * S * ssum :] = shift.reshape(-1)
    taps = {}
    for sid, (w, ys, xs, n) in enumerate(meta):
        ipack[sid, :P] = ys
        ipack[sid, P : 2 * P] = xs
        col, fb = 2 * P, 0
        for sz in sizes:
            a, bt, c0, c1 = mp._taps(w, sz)
            ipack[sid, col : col + sz] = a
            ipack[sid, col + sz : col + 2 * sz] = bt
            col += 2 * sz
            fpack[fb + sid * sz : fb + (sid + 1) * sz] = c0
            fpack[fb + S * sz + sid * sz : fb + S * sz + (sid + 1) * sz] = c1
            fb += 2 * S * sz
            taps.setdefault(sz, []).append((a, bt, c0, c1))
        ipack[sid, col : col + n] = 1
    ms = np.random.default_rng(5).uniform(0.2, 0.8, c.landmark_dim).astype(np.float32)
    jflat, jshapes, jvalid = JM._make_synth(S, P, *mj._hw, sizes, D)(
        mj._canv_dev, jnp.asarray(ipack), jnp.asarray(fpack), jnp.asarray(ms)
    )
    jflat = np.asarray(jflat).reshape(b, D)
    ptaps = {
        sz: tuple(torch.from_numpy(np.stack(x).astype(np.int64 if i < 2 else np.float32))
                  for i, x in enumerate(zip(*per)))
        for sz, per in taps.items()
    }
    valid = np.arange(P)[None] < np.asarray([m[3] for m in meta])[:, None]
    pflat, pshapes, pvalid = PM._make_synth(sizes, D)(
        mp._canv_dev,
        torch.from_numpy(np.stack([m[1] for m in meta])),
        torch.from_numpy(np.stack([m[2] for m in meta])),
        ptaps,
        torch.from_numpy(valid),
        torch.from_numpy(shift),
        torch.from_numpy(ms),
    )
    pflat = pflat.numpy().reshape(b, D)
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(pshapes.numpy(), np.asarray(jshapes))
    v = valid.reshape(-1)
    np.testing.assert_array_equal(pflat[v, : o * o], jflat[v, : o * o])
    for sid, (w, ys, xs, n) in enumerate(meta):
        for p in range(n):
            host = PM._subsample(mp.slots[sid]["canvas"], int(xs[p]), int(ys[p]), w, o)
            np.testing.assert_array_equal(pflat[sid * P + p, : o * o].reshape(o, o), host)
    if multi:
        diff = pflat[v, o * o :].astype(np.int32) - jflat[v, o * o :]
        share = float((diff == 0).mean())
        print(f"h/q screen pixels equal to jda_tpu's: {share}")
        assert np.abs(diff).max() <= 1
        assert share >= 0.995, share  # 0.9983 measured on this fixture


# ---------------------------------------------------------------------------
# CanvasHardMiner.generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ms_model():
    """One multi-scale `_tiny_config` stage trained by jda_tpu: its
    validator reads the h/q planes."""
    c = _tiny_config(T=1, K=6, multi_scale=True, feats=(40,), radius=(0.3,),
                     probs=(0.8,), recall=(0.99,), drops=(1,), nps=(1.0,),
                     score_normalization_steps=(2,), mining_th=(0.5,))
    tr = JaxTrainer(c)
    tr.mining_max_batches = 10
    tr.mining_batch = 512
    rows, gts, bgs = build_synthetic(c, n_pos=80, n_bg=4)
    tr.set_synthetic_data(rows, gts, bgs)
    tr.train()
    assert (tr.model.scale > 0).any()
    return c, tr.model


def _validators(c, model, stage, cart):
    jtr = JaxTrainer(c, model=model)
    ptr = Trainer(port_config(c), model=PP.from_arrays(dataclasses.asdict(model)),
                  device="cpu")
    return jtr.make_validator(stage, cart), ptr.make_validator(stage, cart)


@pytest.fixture(scope="module", params=["single-untrained", "single-trained",
                                        "multi-untrained", "multi-trained"])
def canvas_mined(request, two_stage, ms_model):
    """Both canvas miners on the same canvases, rng and validator: an
    untrained cascade (accepts every window) or a trained one (stage 0 of
    the two-stage run, or the multi-scale stage)."""
    scale, kind = request.param.split("-")
    if scale == "single":
        c, model = two_stage[0].c, two_stage[0].model
        stage, cart = 0, 1  # the first two carts of stage 0
    else:
        c, model = ms_model
        stage, cart = 0, c.K - 1
    if kind == "untrained":
        model = j_empty_model(c)
        model.mean_shape = np.random.default_rng(9).uniform(0.3, 0.7, c.landmark_dim)
        stage, cart = 0, -1
    v = _validators(c, model, stage, cart)
    mj, mp = _miners(c, 4, 32)
    out = []
    for m, validator in zip((mj, mp), v):
        rng = np.random.default_rng(7)
        res = m.generate(validator, 48, max_batches=6, rng=rng)
        out.append((res, rng, m.gen))
    return request.param, out


def test_canvas_generate_equal(canvas_mined):
    """Rows, scores, shapes, statistics, the difficulty, the cursor and
    the generator's next draw equal jda_tpu's."""
    name, (((rj, sj, shj, stj), rngj, gj), ((rp, sp, shp, stp), rngp, gp)) = canvas_mined
    assert len(rp) > 0, name
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(shp, shj)
    for k in ("exhausted", "not_hard", "avg_reject_carts", "fp_rate", "bg_used", "difficulty"):
        assert stp[k] == stj[k], (name, k)
    assert (gp._hard_difficulty, gp._canvas_cursor) == (gj._hard_difficulty, gj._canvas_cursor)
    assert rngj.integers(1 << 62) == rngp.integers(1 << 62)
    assert stp["screened"] >= len(rp) and stp["render_s"] > 0
    if name.endswith("untrained"):
        assert len(rp) == 48 and stp["fp_rate"] > 0.9
    else:
        print(f"{name}: {len(rp)} mined, FP {stp['fp_rate']}, difficulty {stp['difficulty']}")
        assert stp["not_hard"] > 0


# ---------------------------------------------------------------------------
# the hard factory
# ---------------------------------------------------------------------------

def test_generate_hard_ladder_matches_jax():
    """A two-argument factory opts into the ladder
    (test_hard_factory_adaptive_difficulty's validator accepts candidates
    rendered at difficulty >= 0.3): the ladder climbs identically in both
    packages; a one-argument factory is not adaptive."""
    c = _tiny_config()
    D = sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))

    def validate(rows):
        ok = rows[:, 0] >= 30
        n = len(rows)
        return ok, rows[:, 1].astype(np.float64), np.zeros((n, c.landmark_dim)), np.full(n, 2)

    out = []
    for g in (JD.NegGenerator(c), PD.NegGenerator(port_config(c))):
        seen = []
        g.load_hard_factory(
            lambda i, d, seen=seen: (
                seen.append(d),
                np.full((c.img_o_size, c.img_o_size), int(d * 100), np.uint8),
            )[1]
        )
        assert g._hard_adaptive
        out.append((g.generate_hard(validate, 64, batch=32, max_batches=20), g, seen))
    ((rj, sj, shj, stj), gj, seen_j), ((rp, sp, shp, stp), gp, seen_p) = out
    assert len(rp) == 64 and rp.shape[1] == D
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(shp, shj)
    assert stp["difficulty"] >= 0.3 and not stp["exhausted"]
    for k in stj:
        assert stp[k] == stj[k], k
    assert seen_p == seen_j
    assert (gp._hard_difficulty, gp._hard_cursor) == (gj._hard_difficulty, gj._hard_cursor)
    assert stp["screened"] == gp._hard_cursor
    g1 = PD.NegGenerator(port_config(c))
    g1.load_hard_factory(lambda i: np.zeros((c.img_o_size, c.img_o_size), np.uint8))
    assert not g1._hard_adaptive
    with pytest.raises(RuntimeError, match="load_hard_factory"):
        PD.NegGenerator(port_config(c)).generate_hard(validate, 4)


# ---------------------------------------------------------------------------
# the trainer's three branches
# ---------------------------------------------------------------------------

TOPUP_CASES = {
    # the canvas miner fills the scan's shortfall
    "canvas": dict(canvas="1", events=1),
    # JDA_TPU_CANVAS_MINER=0: the hard factory fills it
    "hard": dict(canvas="0", events=1),
    # a second event after the first: the scan is cut to 8 batches
    "scan-cut": dict(canvas="1", events=2),
}


@pytest.mark.parametrize("case", list(TOPUP_CASES))
def test_more_neg_samples_matches_jax(case, monkeypatch):
    """more_neg_samples with both factories registered and a starved host
    scan (16-window batches, 2 batches): the mined count, the negative
    corpus, the generators' state and the trainer's Generator equal
    jda_tpu's; the port's event records say which branches ran."""
    kw = TOPUP_CASES[case]
    monkeypatch.setenv("JDA_TPU_DEVICE_MINER", "0")
    monkeypatch.setenv("JDA_TPU_CANVAS_MINER", kw["canvas"])
    c = _tiny_config()
    rows, gts, bgs = build_synthetic(c, n_pos=100, n_bg=1)
    out = []
    for tr in (JaxTrainer(c), Trainer(port_config(c), device="cpu")):
        tr.mining_max_batches = 2
        tr.mining_batch = 16
        tr.set_synthetic_data(rows, gts, bgs)
        _register(tr, c)
        mined = [tr.more_neg_samples(0, 0)]
        if kw["events"] == 2:
            tr.neg.remove(np.inf)  # every negative gone: a second event
            mined.append(tr.more_neg_samples(0, 0))
        out.append((tr, mined))
    (a, ma), (b, mb) = out
    assert mb == ma and mb[-1] == 100
    np.testing.assert_array_equal(b.neg.imgs, a.neg.imgs)
    np.testing.assert_array_equal(b.neg.scores, a.neg.scores)
    np.testing.assert_array_equal(b.neg.current_shapes, a.neg.current_shapes)
    np.testing.assert_array_equal(b.neg.live, a.neg.live)
    assert _gen_state(b.neg_gen) == _gen_state(a.neg_gen)
    assert b._last_scan_fp == a._last_scan_fp
    assert a.rng.integers(1 << 62) == b.rng.integers(1 << 62)
    ev = b.stats["mining"]
    assert len(ev) == kw["events"]
    first = ev[0]
    assert first["max_batches"] == 2 and first["scan_mined"] == 32
    assert first["mined"] == 100 and first["want"] == 100
    if case == "hard":
        assert first["canvas"] is None and first["hard"]["mined"] == 68
        assert first["hard"]["screened"] == b.neg_gen._hard_cursor
        assert b._canvas_miner is None
    else:
        assert first["canvas"]["mined"] == 68 and first["canvas"]["want"] == 68
        assert first["canvas"]["screened"] > 0 and first["hard"] is None
    if case == "scan-cut":
        assert ev[1]["max_batches"] == 8  # max(2 // 25, 8)
        assert ev[1]["scan_mined"] == 100 and ev[1]["canvas"] is None


# ---------------------------------------------------------------------------
# two stages with both factories
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_stage():
    """A T=2 run of both trainers with both factories registered and a
    starved device scan (2 scan states, 64 windows each, 1 batch)."""
    c = _tiny_config(K=8)
    rows, gts, bgs = build_synthetic(c, n_pos=150, n_bg=4)

    def setup(tr):
        tr.mining_batch = 16
        tr.mining_max_batches = 1
        tr.neg_gen.n_states = 2
        tr.neg_gen.load_images(bgs, tr.rng)
        _register(tr, tr.c)

    return train_both(c, rows, gts, bgs, 1, setup=setup)


def test_two_stage_model_equal(two_stage):
    """Stage 0 bit-equal but W; stage 1 (trained on shapes that stage 0's W
    moved) within W_LATER_REL_TOL; the share of equal splits 1.0."""
    a, b = two_stage
    assert model_diffs(a.model, b.model, later_from=1) == []
    share = split_share(a.model, b.model)
    print(f"two stages with both factories: share of equal splits {share}")
    assert share == 1.0
    assert (b.model.stage_idx, b.model.cart_idx) == (2, -1)


def test_two_stage_mining_equal(two_stage):
    """The corpus, the generators' state and the Generator's next draw
    equal; the events took the canvas top-up and the scan cut."""
    a, b = two_stage
    np.testing.assert_array_equal(b.neg.imgs, a.neg.imgs)
    np.testing.assert_array_equal(b.neg.live, a.neg.live)
    np.testing.assert_array_equal(b.pos.live, a.pos.live)
    assert _gen_state(b.neg_gen) == _gen_state(a.neg_gen)
    assert a.rng.integers(1 << 62) == b.rng.integers(1 << 62)
    ev = b.stats["mining"]
    assert len(ev) >= 2
    assert any(e["canvas"] is not None for e in ev)
    assert any(e["max_batches"] != 1 for e in ev[1:])  # the scan cut


# ---------------------------------------------------------------------------
# describe_cart
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship_models():
    path = os.path.join(ROOT, "models", "flagship_synth.model")
    return JP.load_model(path), PP.load_model(path)


@pytest.mark.parametrize("t,k", [(0, 0), (0, 539), (4, 539)])
def test_describe_cart_flagship(flagship_models, t, k):
    jm, pm = flagship_models
    assert pm.describe_cart(t, k) == jm.describe_cart(t, k)


def test_describe_cart_synthetic():
    jm = JP.synthetic_model(T=2, K=6, landmark_n=5, seed=8, reject_rate=0.1)
    pm = PP.from_arrays(dataclasses.asdict(jm))
    for t in range(2):
        for k in range(6):
            assert pm.describe_cart(t, k) == jm.describe_cart(t, k)
    assert pm.describe_cart(1, 5).startswith("Cart (stage 2, cart 6)\nnode parameters\n")
