"""C-API detection through jda_tpu_torch, held against the JAX package's
fused path (make_fused_fn on the CPU, as its own tests run it) and against
the native C library.

Against JAX every float is bit-equal: the port replays the same float32 op
sequence.  Against the C library the tolerances are the JAX package's own
(tests/test_native.py): identical boxes, scores within 2e-4 and shapes
within 2e-3, since the library is a separate C implementation.
"""

import dataclasses

import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.detect import Detector as JDetector
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


def test_unported_branches_raise(pair):
    m, grays, jres, jraw, tdet, imgs, dims = pair
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdet.detect_batch(grays, mesh=object())
    ms = TP.synthetic_model(T=1, K=8, landmark_n=9, seed=1, multi_scale=True)
    with pytest.raises(NotImplementedError, match="ROADMAP A.9"):
        Detector(ms, device="cpu").detect(grays[0])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdet._run_batch()

