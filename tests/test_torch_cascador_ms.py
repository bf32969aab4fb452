"""Multi-scale models on the C++-semantics path, and the similarity
transform, against the JAX package on the CPU.

Method 0 of a multi-scale model runs stage 0 through the dense multi-scale
filter (node_tables_ms, the plain `stage0_filter_all_scales_ms`) and only
its survivors through per-window patches and the full cascade: bit-equal to
the JAX package's `_detect_m0_dense_ms`, and to the port's own per-window
host loop.  With `with_similarity_transform` the port's means, sums and 2x2
products may round differently from XLA's, so it is held to the JAX
package's own tolerances (tests/test_st_detect.py:137-141): the same alive
masks, scores within 2e-6 and shapes within 2e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.cascador import CppDetector as JCppDetector
from jda_tpu.cascador import DetectionStatistic as JStat
from jda_tpu.config import Config as JConfig
from jda_tpu.ops import dense0 as JD0
from jda_tpu_torch import params as TP
from jda_tpu_torch.cascador import CppDetector, DetectionStatistic
from jda_tpu_torch.config import Config
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import dense0 as D0
from test_torch_cascador import _image, assert_same

IMG = _image(7, 80, 100)
CFG = dict(
    T=2, K=16, landmark_n=5, tree_depth=4, img_o_size=32, img_h_size=24,
    img_q_size=16, fddb_minimum_size=24, fddb_step=4, fddb_scale_factor=1.6,
    fddb_overlap=0.3, fddb_nms=True, left_pupils=(0,), right_pupils=(1,),
)


@pytest.fixture(scope="module")
def ms_model():
    m = JP.synthetic_model(T=2, K=16, landmark_n=5, tree_depth=4, seed=13,
                           multi_scale=True, drop_profile=np.full(32, 0.05))
    assert (np.asarray(m.scale) != 0).any()  # reads the h and q patches
    return m, TP.from_arrays(dataclasses.asdict(m))


def _pair(ms_model, **kw):
    m, tm = ms_model
    cfg = dict(CFG, **kw)
    return (
        JCppDetector(m, JConfig(**cfg)),
        CppDetector(tm, Config(**cfg), device="cpu"),
    )


def _canvas(det, img):
    """The packed method-0 canvas of an image and its band origins and
    grids, as `_detect_m0_dense_ms` lays them out."""
    win, step = det.c.img_o_size, det.c.fddb_step
    layout = det._m0_layout(*img.shape)
    canvas = np.zeros((layout[-1][0] + layout[-1][1], img.shape[1]), np.uint8)
    for (y0, h, w), (level, _) in zip(layout, det._pyramid_m0(img)):
        canvas[y0 : y0 + h, :w] = level
    meta = tuple((win, step, (h - win) // step + 1, (w - win) // step + 1)
                 for _, h, w in layout)
    return canvas, [y0 for y0, _, _ in layout], meta


def test_ms_tables_and_plain_filter_match_jax(ms_model):
    """node_tables_ms, shifted to the bands of a packed canvas, and the
    plain multi-scale filter over the canvas, bit-equal to the JAX
    package's (the canvas and grids of test_dense_ms_matches_jax_and_host,
    which then reuses the JAX package's compiled filter)."""
    jdet, tdet = _pair(ms_model, fddb_detect_method=0)
    sizes = (32, 24, 16)
    a = JD0.node_tables_ms(jdet.det._ms32, jdet.det._host_stage0, 32, 4, sizes)
    b = D0.node_tables_ms(tdet.det._ms32, tdet.det._host_stage0, 32, 4, sizes)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
    canvas, y0s, meta = _canvas(tdet, IMG)
    assert len(meta) == 2 and y0s[-1] > 0
    ja = tuple(JD0.shift_tables(a, y0, 0, 4) for y0 in y0s)
    tb = tuple(D0.shift_tables(b, y0, 0, 4) for y0 in y0s)
    for x, y in zip(ja[-1].values(), tb[-1].values()):
        np.testing.assert_array_equal(np.asarray(x), y)
    want = JD0.stage0_filter_all_scales_ms(
        jnp.asarray(canvas.astype(np.int32))[None], ja, meta=meta, depth=4
    )
    got = D0.stage0_filter_all_scales_ms(
        torch.from_numpy(canvas)[None], tb, meta=meta, depth=4
    )
    for name, x, y in zip(("score", "alive", "nvis"), want, got):
        np.testing.assert_array_equal(np.asarray(x), y.numpy(), err_msg=name)
    assert 0 < int(got[1].sum()) < got[1].numel()
    with pytest.raises(ValueError, match="outside the image"):
        D0.stage0_filter_all_scales_ms(
            torch.from_numpy(canvas[: y0s[-1]])[None], tb, meta=meta, depth=4
        )


def test_dense_ms_matches_jax_and_host(ms_model):
    jdet, tdet = _pair(ms_model, fddb_detect_method=0)
    assert tdet._m0_dense_ms_applicable() and jdet._m0_dense_ms_applicable()
    assert not tdet._m0_fast_applicable()
    img = IMG
    js, ts, hs = JStat(), DetectionStatistic(), DetectionStatistic()
    want = jdet._detect_m0_dense_ms(img, js) + (js,)
    got = tdet._detect_m0_dense_ms(img, ts) + (ts,)
    assert_same(want, got, "dense multi-scale method 0")
    assert_same(got, tdet._detect_m0_host(img, hs) + (hs,), "dense against host")
    assert ts.patch_n > 200 and 0 < ts.face_patch_n < ts.patch_n, ts
    # detect() takes the dense route and then NMS, as the JAX package does
    assert_same(jdet.detect(img), tdet.detect(img), "detect")


def test_dense_ms_switch_read_at_call_time(ms_model, monkeypatch):
    _, tdet = _pair(ms_model, fddb_detect_method=0)
    img = _image(8, 64, 80)
    dense = tdet.detect(img)
    monkeypatch.setenv("JDA_TPU_M0_DENSE_MS", "0")
    assert not tdet._m0_dense_ms_applicable()
    assert_same(dense, tdet.detect(img), "JDA_TPU_M0_DENSE_MS=0 (host loop)")


def test_validate_patches_with_stp_matches_jax(ms_model):
    """The full cascade with the per-stage similarity transform on random
    o/h/q patch rows: alive equal, scores within 2e-6, shapes within
    2e-5."""
    jdet, tdet = _pair(ms_model, fddb_detect_method=0, with_similarity_transform=True)
    D = 32 * 32 + 24 * 24 + 16 * 16
    rows = np.random.default_rng(4).integers(0, 256, (64, D)).astype(np.uint8)
    ja, jsc, jsh, jnv = jdet._validate_patches(rows)
    ta, tsc, tsh, tnv = tdet._validate_patches(rows)
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(jnv, tnv)
    np.testing.assert_allclose(jsc, tsc, rtol=0, atol=2e-6)
    np.testing.assert_allclose(jsh[ja], tsh[ta], rtol=0, atol=2e-5)
    assert 0 < int(ta.sum()) < len(rows)
    # the transform moves the shapes: without it they differ
    plain = CppDetector(ms_model[1], Config(**CFG), device="cpu")._validate_patches(rows)
    assert np.abs(plain[2][ta] - tsh[ta]).max() > 1e-4


def test_run_batch_with_stp_matches_jax(ms_model):
    """Method 1 of a multi-scale model: the gather prefilter and the stage
    loop of `_run_batch(with_stp=True)`: the same boxes, scores within 2e-6
    and shapes within 2e-5 (relocated to the image, so scaled by the box
    size)."""
    jdet, tdet = _pair(ms_model, fddb_detect_method=1, with_similarity_transform=True)
    img = _image(9, 64, 80)
    want, got = jdet.detect(img), tdet.detect(img)
    np.testing.assert_array_equal(want[0], got[0])
    assert dataclasses.astuple(want[3]) == dataclasses.astuple(got[3])
    np.testing.assert_allclose(want[1], got[1], rtol=0, atol=2e-6)
    size = got[0][:, 2:3].astype(np.float64)
    np.testing.assert_allclose(want[2] / size, got[2] / size, rtol=0, atol=2e-5)
    assert len(got[0]) > 0


def test_stp_identity_when_shape_is_mean(ms_model):
    ms = torch.from_numpy(ms_model[1].mean_shape.astype(np.float32))
    stp = C.st_calc_dev(ms.expand(3, -1), ms)
    assert torch.equal(stp, torch.eye(2).expand(3, 2, 2))
