"""C-API detection through jda_tpu_torch, held against the JAX package's
fused path (make_fused_fn on the CPU, as its own tests run it), against its
non-fused path (JDA_TPU_FUSED=0, multi-scale and T == 0 models) and against
the native C library.

Against JAX every float is bit-equal: the port replays the same float32 op
sequence.  Against the C library the tolerances are the JAX package's own
(tests/test_native.py): identical boxes, scores within 2e-4 and shapes
within 2e-3, since the library is a separate C implementation.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.detect import Detector as JDetector
from jda_tpu.detect import window_geometry as j_window_geometry
from jda_tpu.ops import resize as JR
import jda_tpu_torch
from jda_tpu_torch import native as TN
from jda_tpu_torch import params as TP
from jda_tpu_torch.detect import Detector, enumerate_windows
from jda_tpu_torch.ops import fused as TF

TH = -5.0


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pair():
    """One model and batch run through both packages (one JAX compile)."""
    m = JP.synthetic_model(T=3, K=20, landmark_n=9, seed=4, reject_rate=0.2)
    grays = [_img(64, 96, 1), _img(56, 80, 2)]
    jdet = JDetector(m)
    jres = jdet.detect_batch(grays, th=TH)
    # the raw fused output of the same compiled plan
    plan = jdet._fused_plan(2, 64, 96, 1.25, 24, 64)
    imgs = np.zeros((2, 64, 96), np.uint8)
    for i, g in enumerate(grays):
        imgs[i, : g.shape[0], : g.shape[1]] = g
    dims = np.array([[g.shape[1], g.shape[0]] for g in grays], np.int32)
    jraw = {
        k: np.asarray(v)
        for k, v in jdet._fused_run(plan, imgs, dims).items()
    }
    tdet = Detector(TP.from_arrays(dataclasses.asdict(m)), device="cpu")
    return m, grays, jres, jraw, tdet, imgs, dims


def test_run_fused_matches_make_fused_fn(pair):
    m, grays, jres, jraw, tdet, imgs, dims = pair
    plan = tdet._plan(64, 96, 1.25, 24, 64)
    out = TF.run_fused(
        tdet.dev, torch.from_numpy(imgs), torch.from_numpy(dims), plan["tabs"],
        plan["xywin"], meta=plan["scales"], depth=4, leaf_n=m.leaf_n, T=m.T,
        H=64, W=96, s0_lbf=True,
    )
    out = {k: v.numpy() for k, v in out.items()}
    jalive = (jraw["sel"] >= 0) & jraw["alive"]
    jids = jraw["sel"][jalive]
    tids = out["sel"][out["alive"]]
    assert len(jids) > 0, "degenerate fixture"
    np.testing.assert_array_equal(np.sort(jids), np.sort(tids))
    jo, to = np.argsort(jids), np.argsort(tids)
    for k in ("score", "shape", "nvis"):
        np.testing.assert_array_equal(jraw[k][jalive][jo], out[k][out["alive"]][to], err_msg=k)
    np.testing.assert_array_equal(jraw["nvis_img"], out["nvis_img"])
    assert int(jraw["total_nvis"]) == int(out["total_nvis"])
    np.testing.assert_array_equal(jraw["counts"], out["counts"])


def test_run_fused_redescent_equals_lbf(pair):
    """s0_lbf=False re-descends stage 0 on the survivors instead of
    reading the dense filter's leaf words: the same results."""
    m, grays, jres, jraw, tdet, imgs, dims = pair
    plan = tdet._plan(64, 96, 1.25, 24, 64)
    kw = dict(meta=plan["scales"], depth=4, leaf_n=m.leaf_n, T=m.T, H=64, W=96)
    args = (tdet.dev, torch.from_numpy(imgs), torch.from_numpy(dims),
            plan["tabs"], plan["xywin"])
    a = TF.run_fused(*args, s0_lbf=True, **kw)
    b = TF.run_fused(*args, s0_lbf=False, **kw)
    for k in ("sel", "score", "shape", "alive", "nvis", "nvis_img", "counts"):
        assert torch.equal(a[k], b[k]), k


def test_detect_batch_matches_jax(pair):
    m, grays, jres, jraw, tdet, imgs, dims = pair
    tres = tdet.detect_batch(grays, th=TH)
    assert sum(r.n for r in jres) > 0, "degenerate fixture"
    for a, b in zip(jres, tres):
        assert a.n == b.n
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.shapes, b.shapes)
    single = tdet.detect(grays[1], th=TH)
    np.testing.assert_array_equal(single.bboxes, tres[1].bboxes)
    np.testing.assert_array_equal(single.shapes, tres[1].shapes)
    one_shot = jda_tpu_torch.detect(tdet.params, grays[0], device="cpu", th=TH)
    np.testing.assert_array_equal(one_shot.scores, tres[0].scores)


def test_detect_stream_equals_detect_batch(pair):
    m, grays, jres, jraw, tdet, imgs, dims = pair
    more = grays + [_img(64, 90, 3)]
    stream = tdet.detect_stream(more, batch=2, th=TH)
    batch = tdet.detect_batch(more, th=TH)
    assert len(stream) == len(more)
    for a, b in zip(batch, stream):
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.shapes, b.shapes)


def test_matches_native_c_library(tmp_path):
    """Bench-geometry model (T=5, K=540, 27 landmarks) against the native
    C library on one image."""
    m = TP.synthetic_model(T=5, K=540, landmark_n=27, seed=21, reject_rate=0.10)
    path = str(tmp_path / "m.model")
    TP.save_model(m, path, dtype="double")
    img = _img(96, 128, 6)
    nb, nsh, nsc = TN.NativeDetector(path, dtype="double").detect(img, th=TH)
    res = Detector(TP.load_model(path), device="cpu").detect(img, th=TH)
    assert len(nb) > 0, "degenerate fixture"
    np.testing.assert_array_equal(nb, res.bboxes)
    np.testing.assert_allclose(nsc, res.scores, rtol=0, atol=2e-4)
    np.testing.assert_allclose(nsh, res.shapes, rtol=0, atol=2e-3)


def test_enumerate_windows_bench_counts():
    """The window ladders of the bench shapes (VGA and 1080p)."""
    x, _, _, scales = enumerate_windows(640, 480, 1.25, 24, 480)
    assert len(x) == 169706 and len(scales) == 14
    x, _, _, scales = enumerate_windows(1920, 1080, 1.25, 24, 1080)
    assert len(x) == 1245268 and len(scales) == 18


def _same(a, b):
    assert a.n == b.n
    np.testing.assert_array_equal(a.bboxes, b.bboxes)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.shapes, b.shapes)


@pytest.mark.parametrize("rounding", [False, True], ids=["trunc", "round"])
def test_unfused_detect_matches_jax_and_fused(monkeypatch, rounding):
    """JDA_TPU_FUSED=0 sends a single-scale model through the dense filter
    of one image plus cascade_full on the survivors, in both packages:
    boxes, scores and shapes bit-equal to jda_tpu's, and to the port's own
    fused result on the same image."""
    m = JP.synthetic_model(T=3, K=20, landmark_n=9, seed=4, reject_rate=0.2)
    tm = TP.from_arrays(dataclasses.asdict(m))
    img = _img(64, 96, 1)
    fused = Detector(tm, rounding=rounding, device="cpu").detect(img, th=TH)
    monkeypatch.setenv("JDA_TPU_FUSED", "0")
    jdet = JDetector(m, rounding=rounding)
    tdet = Detector(tm, rounding=rounding, device="cpu")
    assert not jdet._fused_enabled() and not tdet._fused_enabled()
    jres = jdet.detect(img, th=TH)
    tres = tdet.detect(img, th=TH)
    assert jres.n > 0, "degenerate fixture"
    _same(jres, tres)
    _same(fused, tres)
    monkeypatch.setenv("JDA_TPU_FUSED", "1")
    assert tdet._fused_enabled()  # read at call time


def _geometry_batch(img, single_scale):
    H, W = img.shape
    levels = (
        (img, np.zeros((1, 1), np.uint8), np.zeros((1, 1), np.uint8))
        if single_scale
        else JR.pyramid_c(img)
    )
    flat, offsets, strides = JR.stack_pyramid(levels)
    x, y, win, scales = enumerate_windows(W, H, 1.25, 24, min(H, W))
    return flat, j_window_geometry(x, y, win, offsets, strides), scales


@pytest.mark.parametrize("dense", [False, True], ids=["prefilter", "dense"])
def test_run_batch_matches_jax(dense):
    """One geometry batch through _run_batch in both packages: score,
    alive, shape and nvis of every window bit-equal, with the gather
    prefilter (8 of 20 carts) and with a dense result taken over."""
    m = JP.synthetic_model(T=3, K=20, landmark_n=9, seed=4, reject_rate=0.2)
    img = _img(64, 96, 1)
    flat, geom, scales = _geometry_batch(img, single_scale=True)
    jdet = JDetector(m, prefilter_carts=8)
    tdet = Detector(TP.from_arrays(dataclasses.asdict(m)), prefilter_carts=8, device="cpu")
    n = geom["base"].shape[0]
    dense_result = jdet._dense_filter(img, scales) if dense else None
    jout = jdet._run_batch(jnp.asarray(flat.astype(np.int32)), geom, n,
                           dense_result=dense_result)
    tout = tdet._run_batch(torch.from_numpy(flat), geom, n, dense_result=dense_result)
    assert 0 < jout["alive"].sum() < n, "degenerate fixture"
    # some windows die in the prefilter, some in the stage loop
    assert len(np.unique(jout["nvis"])) > 3
    for k in ("score", "alive", "shape", "nvis"):
        assert jout[k].dtype == tout[k].dtype and jout[k].shape == tout[k].shape, k
        np.testing.assert_array_equal(jout[k], tout[k], err_msg=k)
    # a batch padded past valid_n leaves the tail untouched; the prefilter
    # and the dense result give every window the same final values
    part = tdet._run_batch(torch.from_numpy(flat), geom, n // 2)
    np.testing.assert_array_equal(part["alive"][n // 2:], False)
    np.testing.assert_array_equal(part["score"][n // 2:], -np.inf)
    for k in ("score", "alive", "shape", "nvis"):
        np.testing.assert_array_equal(part[k][: n // 2], tout[k][: n // 2], err_msg=k)


def test_multi_scale_detect_matches_jax():
    """A multi-scale model reads the half and quarter pyramid levels and
    takes _run_batch (prefilter, stage loop): the full ladder bit-equal to
    jda_tpu, including the windows whose quarter-level reads run past the
    pyramid's end (cascade.take_fill)."""
    m = JP.synthetic_model(T=3, K=24, landmark_n=9, seed=14, multi_scale=True,
                           reject_rate=0.1)
    tm = TP.from_arrays(dataclasses.asdict(m))
    img = _img(96, 128, 15)
    jdet, tdet = JDetector(m, prefilter_carts=8), Detector(tm, prefilter_carts=8, device="cpu")
    assert not tdet.single_scale and not tdet._fused_enabled()
    jres = jdet.detect(img, th=TH)
    tres = tdet.detect(img, th=TH)
    assert jres.n > 0, "degenerate fixture"
    _same(jres, tres)
    # several geometry batches give the same answer
    _same(tres, tdet.detect(img, th=TH, batch=1000))
    flat, geom, _ = _geometry_batch(img, single_scale=False)
    n = geom["base"].shape[0]
    assert (geom["base"][:, 2].astype(np.int64) + 23 * (geom["stride"][:, 2] + 1)
            >= len(flat)).any(), "no window reads past the pyramid's end"
    jout = jdet._run_batch(jnp.asarray(flat.astype(np.int32)), geom, n)
    tout = tdet._run_batch(torch.from_numpy(flat), geom, n)
    for k in ("score", "alive", "shape", "nvis"):
        np.testing.assert_array_equal(jout[k], tout[k], err_msg=k)


def test_multi_scale_matches_native_c_library(tmp_path):
    """A multi-scale model of the bench geometry against the native C
    library: same boxes, scores within 2e-4, shapes within 2e-3 (the
    tolerances of tests/test_detect_parity.py).

    Near the bottom edge the C library's half and quarter patches read past
    their buffers into unrelated memory, which nothing can reproduce; as in
    tests/test_detect_parity.py the window size is pinned to 24 and boxes
    are compared where every read stays inside the pyramid, a further 24 px
    away from the rest so that NMS does not couple the two."""
    m = TP.synthetic_model(T=5, K=540, landmark_n=27, seed=14, multi_scale=True,
                           reject_rate=0.05)
    path = str(tmp_path / "m.model")
    TP.save_model(m, path, dtype="double")
    img_h, img_w = 192, 128
    img = _img(img_h, img_w, 15)
    safe_y = img_h - 82 - 24
    kw = dict(scale=1.3, min_size=24, max_size=24, th=-10.0)
    nb, nsh, nsc = TN.NativeDetector(path, dtype="double").detect(img, **kw)
    r = Detector(TP.load_model(path, dtype="double"), device="cpu").detect(img, **kw)
    om, tmask = nb[:, 1] <= safe_y, r.bboxes[:, 1] <= safe_y
    assert om.sum() > 0, "degenerate fixture"
    np.testing.assert_array_equal(r.bboxes[tmask], nb[om])
    np.testing.assert_allclose(r.scores[tmask], nsc[om], rtol=0, atol=2e-4)
    np.testing.assert_allclose(r.shapes[tmask], nsh[om], rtol=0, atol=2e-3)


def test_t0_model_returns_no_boxes():
    """A model without stages takes the non-fused branch and accepts
    nothing, in both packages."""
    m = JP.synthetic_model(T=0, K=8, landmark_n=9, seed=1)
    img = _img(64, 96, 1)
    jres = JDetector(m).detect(img, th=TH)
    tdet = Detector(TP.from_arrays(dataclasses.asdict(m)), device="cpu")
    tres = tdet.detect(img, th=TH)
    assert jres.n == tres.n == 0
    assert tres.bboxes.shape == (0, 3) and tres.shapes.shape == (0, 18)
    assert tdet.detect_batch([img, img], th=TH)[1].n == 0


def test_batch_and_stream_fall_back_image_by_image(monkeypatch, pair):
    """Where the fused path does not serve (here JDA_TPU_FUSED=0; also
    multi-scale models), detect_batch and detect_stream run detect per
    image: the same results as the fused batch."""
    m, grays, jres, jraw, tdet, imgs, dims = pair
    fused = tdet.detect_batch(grays, th=TH)
    monkeypatch.setenv("JDA_TPU_FUSED", "0")
    calls = []
    monkeypatch.setattr(
        tdet, "_detect_unfused",
        lambda *a, _f=tdet._detect_unfused, **k: calls.append(1) or _f(*a, **k),
    )
    batch = tdet.detect_batch(grays, th=TH)
    stream = tdet.detect_stream(grays, batch=2, th=TH)
    assert len(calls) == 2 * len(grays)
    assert tdet.detect_stream([], th=TH) == []
    for a, b, c, j in zip(fused, batch, stream, jres):
        _same(a, b)
        _same(a, c)
        _same(j, b)


def test_unported_branches_raise(pair, monkeypatch):
    m, grays, jres, jraw, tdet, imgs, dims = pair
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        tdet.detect_batch(grays, mesh=object())
    # the canvas-bucket tail of banded plans (the JAX package's mxu_tail.py)
    monkeypatch.setenv("JDA_TPU_BUCKETS", "default")
    z = np.zeros(1, np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP A.13"):
        tdet._plan_windows(("t",), 64, 96, z, z, z + 24, [(24, 2, 1, 1)],
                           rounding=True, origins=[(0, 0)])
