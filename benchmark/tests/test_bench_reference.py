"""The reference agrees with the port at a tiny size on the CPU, exactly,
and its bfloat16 control does not."""

import numpy as np
import pytest
import torch

from benchmark import frozen as F
from benchmark import harness as H
from benchmark import reference as R
from jda_tpu_torch import params as P
from jda_tpu_torch.cascador import CppDetector
from jda_tpu_torch.config import Config
from jda_tpu_torch.detect import Detector, enumerate_windows
from jda_tpu_torch.ops import nms as NMS


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(4)
    m = F.synthetic_model(2, 24, 27, 4, 7)
    return m, P.from_arrays(dict(m, stage_idx=3, cart_idx=-1))


def test_c_api_matches_the_port(tiny):
    m, pm = tiny
    imgs = np.stack([F.make_image(96, 128, 100 + i) for i in range(4)])
    ladder = R.c_api_ladder(96, 128, 1.25, 24, -1)
    per, xyw = R.run_cascade(R.Cascade(m, "cpu"), imgs, ladder, rounding=False)
    want = R.c_api_answers(per, xyw, -0.5)
    det = Detector(pm, device="cpu")
    got = det.detect_stream(list(imgs), batch=4, scale=1.25, min_size=24, max_size=-1, th=-0.5)
    assert det.last_stats["total_nvis"] == sum(p["visits"] for p in per)
    assert sum(len(w[0]) for w in want) > 20
    for (boxes, scores, shapes), r in zip(want, got):
        assert np.array_equal(boxes, r.bboxes)
        assert np.array_equal(scores, r.scores) and np.array_equal(shapes, r.shapes)
    one = det.detect(imgs[1], scale=1.25, min_size=24, max_size=-1, th=-0.5)
    assert np.array_equal(one.bboxes, want[1][0]) and np.array_equal(one.shapes, want[1][2])


def test_cpp_method1_matches_the_port(tiny):
    m, pm = tiny
    scenes = np.stack([F.make_scene(160, 200, 200 + i, 1)[0] for i in range(3)])
    c = Config(fddb_detect_method=1)
    ladder = R.cpp_m1_ladder(160, 200, c.fddb_minimum_size, c.fddb_step, c.fddb_scale_factor)
    per, xyw = R.run_cascade(R.Cascade(m, "cpu"), scenes, ladder, rounding=True)
    want = R.cpp_answers(per, xyw, c.fddb_overlap)
    got = CppDetector(pm, c, device="cpu").detect_batch(list(scenes))
    for w, g in zip(want, got):
        st = g[3]
        assert np.array_equal(w[0], g[0])
        assert np.array_equal(w[1], g[1]) and np.array_equal(w[2], g[2])
        assert w[3] == (st.patch_n, st.face_patch_n, st.nonface_patch_n, st.cart_gothrough_n)


@pytest.mark.parametrize("H_,W_", [(480, 640), (1080, 1920), (96, 128)])
def test_ladders(H_, W_):
    assert R.c_api_ladder(H_, W_, 1.25, 24, -1) == [
        tuple(int(v) for v in s) for s in enumerate_windows(W_, H_, 1.25, 24, min(H_, W_))[3]]
    cpp = CppDetector(P.from_arrays(dict(F.synthetic_model(1, 8, 27, 4, 0), stage_idx=2, cart_idx=-1)),
                      Config(fddb_detect_method=1), device="cpu")
    assert R.cpp_m1_ladder(H_, W_, 20, 5, 1.3) == [
        tuple(int(v) for v in s) for s in cpp._enumerate_m1(W_, H_)[3]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_variants(seed):
    rng = np.random.default_rng(seed)
    n = 60
    boxes = np.stack([rng.integers(0, 200, n), rng.integers(0, 200, n), rng.integers(20, 80, n)], 1)
    scores = rng.normal(size=n).astype(np.float32)
    assert np.array_equal(R.nms_c(boxes, scores), NMS.nms_c(boxes, scores, 0.3))
    rects = np.concatenate([boxes, boxes[:, 2:3]], 1).astype(np.int32)
    s64 = scores.astype(np.float64)
    s64[5] = s64[9]  # a tie: the later insertion is picked first
    assert np.array_equal(R.nms_cpp(rects, s64), NMS.nms_cpp(rects, s64, 0.3))


def test_exchange_sort_ties():
    # equal scores: the C library's exchange sort, not a stable sort
    boxes = np.array([[0, 0, 30], [5, 0, 30], [200, 0, 30]])
    scores = np.array([1.0, 1.0, 2.0], np.float32)
    assert list(R.nms_c(boxes, scores)) == [1, 2]


@pytest.mark.parametrize("workload", ["vga_stream_b16", "fddb_scenes_m1_b8"])
def test_control_fails(workload):
    """The reference in bfloat16 in the program's place comes out not
    correct under the cell's limits (at a small size)."""
    torch.set_num_threads(4)
    c = H.resolve(H.load_spec(), workload)
    config, traffic = c["config"], c["traffic"]
    if config["model"]["kind"] == "synthetic":
        config = dict(config, T=2, K=40, model=dict(kind="synthetic", seed=7))
        traffic = dict(traffic, height=96, width=128, pool=4, batch=4)
    else:
        traffic = dict(traffic, height=200, width=240, pool=2, batch=2, faces=1)
    fields = H.model_fields(config)
    for seed in (1, 2, 3):
        pool = H.make_pool(traffic, seed)
        want, per, _ = H.reference(config, traffic, fields, pool, "cpu")
        got, per_b, _ = H.reference(config, traffic, fields, pool, "cpu", dtype=torch.bfloat16)
        has = config["entry"] == "c_api"
        nums = H.compare(got, want, [sum(p["visits"] for p in per_b)] if has else None,
                         [sum(p["visits"] for p in per)] if has else None)
        assert not H.judge(nums, c["limits"]), nums
