"""The C++-semantics detector (jda_tpu_torch.cascador.CppDetector) against
the JAX package's, on the CPU.

The JAX side runs as its own tests run it: on the CPU, where it takes the
XLA reference filters in place of the Pallas kernels.  Both detectors get
the same synthetic model and images; rects, scores, shapes and the
DetectionStatistic are bit-equal on every route of a single-scale model:
method 1 image by image (dense filter with rounding tables, then
`_run_batch`), method 0 through the packed banded canvas, and both batched
paths with a canonical plane.  The multi-scale routes and the similarity
transform are in test_torch_cascador_ms.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.cascador import CppDetector as JCppDetector
from jda_tpu.config import Config as JConfig
from jda_tpu.ops import dense0 as JD0
from jda_tpu.ops import nms as JNMS
from jda_tpu_torch import params as TP
from jda_tpu_torch.cascador import CppDetector
from jda_tpu_torch.config import Config
from jda_tpu_torch.ops import dense0 as D0
from jda_tpu_torch.ops import nms as NMS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG = dict(
    T=2, K=24, landmark_n=5, tree_depth=4, img_o_size=32, img_h_size=24,
    img_q_size=16, fddb_minimum_size=24, fddb_step=4, fddb_scale_factor=1.6,
    fddb_overlap=0.3, fddb_nms=True, left_pupils=(0,), right_pupils=(1,),
)


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 10, (h, w)), 0, 255).astype(np.uint8)


def assert_same(a, b, what):
    """(rects, scores, shapes, stat) bit-equal, the statistic field by
    field."""
    for name, x, y in zip(("rects", "scores", "shapes"), a[:3], b[:3]):
        assert x.dtype == y.dtype and x.shape == y.shape, (what, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")
    assert dataclasses.astuple(a[3]) == dataclasses.astuple(b[3]), what


@pytest.fixture(scope="module")
def pair():
    """One single-scale model in both packages; a detector per method."""
    # each cart drops 5 % of the windows it sees: about 11 % of the windows
    # pass both stages
    m = JP.synthetic_model(T=2, K=24, landmark_n=5, tree_depth=4, seed=11,
                           drop_profile=np.full(48, 0.05))
    tm = TP.from_arrays(dataclasses.asdict(m))
    dets = {
        method: (
            JCppDetector(m, JConfig(fddb_detect_method=method, **CFG)),
            CppDetector(tm, Config(fddb_detect_method=method, **CFG), device="cpu"),
        )
        for method in (0, 1)
    }
    return m, tm, dets


@pytest.mark.parametrize("method", [1, 0])
def test_detect_matches_jax(pair, method):
    jdet, tdet = pair[2][method]
    assert tdet._m0_fast_applicable() and jdet._m0_fast_applicable()
    img = _image(4, 120, 150)
    want = jdet.detect(img)
    got = tdet.detect(img)
    assert_same(want, got, f"method {method}")
    stat = got[3]
    assert len(got[0]) > 0 and 0 < stat.face_patch_n < stat.patch_n, stat
    assert stat.cart_gothrough_n > stat.nonface_patch_n


@pytest.mark.parametrize("method", [1, 0])
def test_detect_batch_with_canon_matches_jax(pair, method):
    """Mixed sizes on a canonical plane larger than every image: each image
    bit-equal to the JAX package's batch, and to the port's own detect."""
    jdet, tdet = pair[2][method]
    grays = [_image(6, 96, 128), _image(7, 80, 100), _image(8, 64, 72)]
    fn = "_detect_batch_m1" if method else "_detect_batch_m0"
    want = getattr(jdet, fn)(grays, canon=(128, 128))
    got = getattr(tdet, fn)(grays, canon=(128, 128))
    assert len(got) == len(want) == len(grays)
    for i, (a, b) in enumerate(zip(want, got)):
        assert_same(a, b, f"method {method}, image {i}")
        assert_same(tdet.detect(grays[i]), b, f"method {method}, image {i} alone")
    assert sum(len(r[0]) for r in got) > 0


@pytest.mark.parametrize("method", [1, 0])
def test_tiny_image_is_empty(pair, method):
    jdet, tdet = pair[2][method]
    img = _image(5, 20, 24)  # smaller than every window
    want, got = jdet.detect(img), tdet.detect(img)
    assert_same(want, got, "tiny image")
    assert len(got[0]) == 0 and got[3].patch_n == 0
    assert got[2].shape == (0, 2 * 5)
    batch = tdet.detect_batch([img, img])
    for b in batch:
        assert_same(got, b, "tiny image in a batch")


def test_detect_batch_routes_per_image_when_not_fused(pair, monkeypatch):
    """Under JDA_TPU_FUSED=0 (read at call time) both methods run image by
    image: method 1 through `_detect_m1`, method 0 through the per-window
    host loop (`_detect_m0_host`); the results are those of the fused
    routes."""
    _, _, dets = pair
    grays = [_image(9, 90, 110), _image(10, 72, 96)]
    fused = {m: dets[m][1].detect_batch(grays) for m in (0, 1)}
    monkeypatch.setenv("JDA_TPU_FUSED", "0")
    for m in (0, 1):
        tdet = dets[m][1]
        assert not tdet._m0_fast_applicable()
        for i, r in enumerate(tdet.detect_batch(grays)):
            assert_same(fused[m][i], r, f"method {m}, image {i}, JDA_TPU_FUSED=0")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_cpp_matches_jax_with_ties(seed):
    rng = np.random.default_rng(seed)
    n = 60
    xy = rng.integers(0, 80, (n, 2))
    wh = rng.integers(10, 40, (n, 2))
    rects = np.concatenate([xy, wh], 1).astype(np.int32)
    scores = rng.choice([0.5, 1.0, 1.5, 2.0], n).astype(np.float64)  # many ties
    want = JNMS.nms_cpp(rects, scores, 0.3)
    got = NMS.nms_cpp(rects, scores, 0.3)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(want, got)
    assert 1 < len(got) < n
    assert len(NMS.nms_cpp(rects[:0], scores[:0])) == 0


@pytest.mark.parametrize("origin", [(0, 0), (12, 0), (40, 8)])
def test_shifted_rounding_tables_match_jax(pair, origin):
    m, tm, dets = pair
    jdet, tdet = dets[0][0].det, dets[0][1].det
    for win, step in ((32, 4), (41, 4)):
        a = JD0.shift_tables(
            JD0.node_tables(jdet._ms32, jdet._host_stage0, win, step, rounding=True),
            *origin, step,
        )
        b = D0.shift_tables(
            D0.node_tables(tdet._ms32, tdet._host_stage0, win, step, rounding=True),
            *origin, step,
        )
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
    with pytest.raises(ValueError, match="off the step"):
        D0.shift_tables(b, 3, 0, 4)


def test_config_from_json_matches_jax():
    path = os.path.join(ROOT, "config.template.json")
    a = dataclasses.asdict(JConfig.from_json(path))
    b = dataclasses.asdict(Config.from_json(path))
    assert a == b
    assert Config().leaf_n == JConfig().leaf_n and Config().node_n == JConfig().node_n


def test_prepare_image_bounds_on_banded_canvas(pair):
    """The kernels' tables of a packed method-0 canvas: `prepare_image`
    accepts the shifted tables of the last band, whose reads end on the
    canvas's last row, and refuses the same tables on a canvas one row
    shorter; the ladder's windows fit the int32 index check."""
    tdet = pair[2][0][1]
    plan = tdet._m0_plan(150, 190)
    Hp, W = plan["Hc"], plan["Wc"]
    assert len(plan["scales"]) >= 3 and plan["origins"][-1][0] > 0
    t = D0.prepare_image(plan["tabs"], meta=plan["scales"], depth=4, H=Hp, W=W)
    assert t.n == plan["n"] and t.recs_host[-1, 0] + t.recs_host[-1, 1] * t.recs_host[-1, 3] == t.n
    with pytest.raises(ValueError, match="outside the image"):
        D0.prepare_image(plan["tabs"], meta=plan["scales"], depth=4, H=Hp - 1, W=W)
    D0._check_images("dense0_filter", torch.zeros((8, Hp, W), dtype=torch.uint8), t)
