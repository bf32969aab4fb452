"""A multi-scale model (every node reads the o, h or q level it names)
through the port's C-API Detector, against the benchmark's plain
multi-scale reference (benchmark/reference_ms.py), on the CPU: answers and
cart visits exactly equal, on images whose half and quarter patches read
past the stacked pyramid's end.  On the CPU, and through
`CppDetector.detect`, such a model takes `_run_batch` (on a card the C API
walks it in the tail kernel: tests/test_torch_cuda.py)."""

import json
import os

import numpy as np
import pytest
import torch

from benchmark import frozen as F
from benchmark import model_ms as MM
from benchmark import reference as R
from benchmark import reference_ms as RM
from jda_tpu_torch import params as P
from jda_tpu_torch import tracing
from jda_tpu_torch.cascador import CppDetector
from jda_tpu_torch.config import Config
from jda_tpu_torch.detect import Detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(scale=1.25, min_size=24, max_size=-1, th=-0.5, nms_overlap=0.3)
CONFIG = dict(entry="c_api", detect=KW)
HW = [(60, 80), (72, 56)]  # ladders up to the whole image: windows at the bottom edge


@pytest.fixture(scope="module")
def case():
    torch.set_num_threads(2)
    m = MM.synthetic_model_ms(2, 12, 27, 4, 5)
    det = Detector(P.from_arrays(dict(m, stage_idx=3, cart_idx=-1)), device="cpu")
    imgs = {hw: np.stack([F.make_image(*hw, 10 * i + hw[0]) for i in range(2)]) for hw in HW}
    ref = {hw: RM.answers(CONFIG, {}, m, imgs[hw], "cpu") for hw in HW}
    return m, det, imgs, ref


def _equal(got, want):
    boxes, scores, shapes, _ = want
    assert np.array_equal(got.bboxes, boxes)
    assert np.array_equal(got.scores, scores) and np.array_equal(got.shapes, shapes)


@pytest.mark.parametrize("hw", HW)
def test_reads_pass_the_pyramid_end(hw):
    """The fixture's ladders hold windows whose quarter patch ends past
    the stacked buffer (where the reference reads the int32 minimum)."""
    H, W = hw
    flat, offsets, strides = RM.pyramid(torch.zeros((1, H, W), dtype=torch.uint8), torch.float32)
    x, y, win, _ = R.ladder_windows(R.c_api_ladder(H, W, 1.25, 24, -1))
    last = RM.patch_bases(x, y, offsets, strides)[:, 2] + (win - 1) * strides[2] + win - 1
    assert (last >= flat.shape[1]).any()


@pytest.mark.parametrize("hw", HW)
def test_detect_stream_and_detect_equal_the_reference(case, hw, monkeypatch):
    """Both entry points give the reference's boxes, scores and shapes, and
    `_run_batch`'s per-window visits sum to the reference's per image."""
    _, det, imgs, ref = case
    want, per, _ = ref[hw]
    assert sum(len(a[0]) for a in want) > 0, "degenerate fixture"
    for got, w in zip(det.detect_stream(list(imgs[hw]), batch=2, **KW), want):
        _equal(got, w)
    nvis = []
    run_batch = Detector._run_batch

    def counted(self, *a, **kw):
        out = run_batch(self, *a, **kw)
        nvis.append(int(out["nvis"].sum()))
        return out

    monkeypatch.setattr(Detector, "_run_batch", counted)
    for img, w in zip(imgs[hw], want):
        _equal(det.detect(img, **KW), w)
    assert nvis == [p["visits"] for p in per]


def test_level_zero_is_the_single_scale_reference(case):
    """With every node on level 0 the multi-scale reference gives what
    benchmark/reference.py gives, answers, counts and ladder."""
    m, _, imgs, _ = case
    m0 = dict(m, scale=np.zeros_like(m["scale"]))
    pool = imgs[HW[0]]
    got, got_per, got_ladder = RM.answers(CONFIG, {}, m0, pool, "cpu")
    want, want_per, want_ladder = R.answers(CONFIG, {}, m0, pool, "cpu")
    assert got_ladder == want_ladder
    for a, b in zip(got, want):
        assert all(np.array_equal(x, y) for x, y in zip(a[:3], b[:3]))
    for a, b in zip(got_per, want_per):
        assert (a["windows"], a["visits"], a["finish"]) == (b["windows"], b["visits"], b["finish"])


def test_model_module_is_the_port_generator():
    """benchmark/model_ms.py gives params.synthetic_model(multi_scale=True)'s
    arrays, and the configuration's stored thresholds are a fresh
    calibration of its leaf scores."""
    want = P.synthetic_model(T=2, K=40, landmark_n=27, seed=7, multi_scale=True,
                             drop_profile=P.realistic_drop_profile(2, 40))
    got = MM.synthetic_model_ms(2, 40, 27, 4, 7)
    for k in F.FIELDS:
        assert np.array_equal(got[k], getattr(want, k)), k
    assert set(np.unique(got["scale"])) == {0, 1, 2}
    with open(os.path.join(ROOT, "benchmark/configs/jda_t5k540_ms_synth.json")) as f:
        config = json.load(f)
    m = MM.fields(config, ROOT)
    fresh = F.calibrate_thresholds(m["leaf_scores"], F.realistic_drop_profile(5, 540), 7)
    assert np.array_equal(m["cart_th"], fresh)


def test_cpu_and_cpp_route_take_run_batch(case, monkeypatch):
    """The CPU detector's multi-scale route is `_run_batch` (counted in
    `run_batch.calls` and `.windows`), and so is `CppDetector.detect`'s
    method 1; neither queues a lane to the tail kernel."""
    m, det, imgs, _ = case
    img = imgs[HW[0]][0]
    calls = []
    run_batch = Detector._run_batch
    monkeypatch.setattr(Detector, "_run_batch",
                        lambda self, *a, **kw: calls.append(a[2]) or run_batch(self, *a, **kw))
    cpp = CppDetector(det.params, Config(T=2, K=12, landmark_n=27, fddb_detect_method=1,
                                         fddb_minimum_size=24, fddb_step=8),
                      device="cpu")
    tracing.start()
    try:
        det.detect(img, **KW)
        cpp.detect(img)
    finally:
        tracing.stop()
    _, counters = tracing.drain()
    assert len(calls) == 2 and counters["run_batch.calls"] == 1
    assert counters["run_batch.windows"] == calls[0] > 0 and calls[1] > 0
    assert not any(k.startswith("tail_kernel.") for k in counters)
