"""The port's tracer (jda_tpu_torch/tracing.py) on the CPU: off it records
nothing and costs a flag test, on it changes no result, and its spans and
counters describe the call they were recorded in."""

import time

import numpy as np
import pytest
import torch

import jda_tpu_torch as jt
from jda_tpu_torch import tracing
from jda_tpu_torch.detect import enumerate_windows
from jda_tpu_torch.ops.fused import STAGE_SPLIT

NAMES = {"call", "plan", "upload", "upload.wait", "dense0", "tail", "stage", "compact",
         "descend", "score_chain", "regression", "harvest", "harvest.wait", "nms", "pyramid",
         "run_batch"}


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.stop()
    tracing.drain()
    yield
    tracing.stop()
    tracing.drain()


def make_image(h, w, seed):
    """Blocky texture plus noise (bench_torch.make_image)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _recorded(fn):
    """fn() with tracing on: (its result, spans, counters)."""
    tracing.start()
    try:
        out = fn()
    finally:
        tracing.stop()
    return (out,) + tracing.drain()


@pytest.fixture(scope="module")
def vga():
    """A small cascade (T=3, K=32) over two VGA textures, once without and
    once with tracing; the detector's plan is built by a first call."""
    torch.set_num_threads(2)
    m = jt.synthetic_model(T=3, K=32, landmark_n=9, seed=4, reject_rate=0.5)
    det = jt.Detector(m, device="cpu")
    imgs = [make_image(480, 640, s) for s in (1, 2)]
    tracing.start()
    det.detect_batch(imgs, th=-5.0)
    tracing.stop()
    first = tracing.drain()[1]
    off = det.detect_batch(imgs, th=-5.0)
    on, spans, counters = _recorded(lambda: det.detect_batch(imgs, th=-5.0))
    return dict(det=det, off=off, on=on, spans=spans, counters=counters, first=first,
                stats=det.last_stats)


def _lane_carts(counts, T, K):
    """Lanes x carts the fused pass descends, from its survivor counts:
    stage 0's leaves come from the dense filter; each later stage descends
    its first STAGE_SPLIT carts on the lanes that enter it and the rest on
    those left after the split's compaction (K > 2 * STAGE_SPLIT), or all
    K carts on the lanes that enter it."""
    split = K > 2 * STAGE_SPLIT
    entering, total, i = counts[0], 0, 1
    for t in range(1, T):
        if split:
            total += entering * STAGE_SPLIT + counts[i] * (K - STAGE_SPLIT)
            i += 1
        else:
            total += entering * K
        if t < T - 1:
            entering = counts[i]
            i += 1
    return total


def test_off_records_nothing():
    m = jt.synthetic_model(T=2, K=8, landmark_n=9, seed=3, reject_rate=0.3)
    det = jt.Detector(m, device="cpu")
    img = make_image(60, 80, 5)
    det.detect(img, th=-5.0)
    det.detect_batch([img, img], th=-5.0)
    assert tracing.drain() == ([], {})


def test_results_bit_equal_on_and_off(vga):
    assert sum(r.n for r in vga["off"]) > 0, "degenerate fixture"
    for a, b in zip(vga["off"], vga["on"]):
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.shapes, b.shapes)


def test_spans_nest_in_one_call(vga):
    spans = vga["spans"]
    assert {s.name for s in spans} <= NAMES
    calls = [i for i, s in enumerate(spans) if s.name == "call"]
    assert len(calls) == 1 and spans[0].name == "call" and spans[0].parent == -1
    assert spans[0].entry == "detect_batch" and spans[0].B == 2
    for s in spans[1:]:
        assert s.parent >= 0 and s.call == spans[0].call
        p = spans[s.parent]
        assert p.start <= s.start <= s.end <= p.end, (s, p)
    stages = [s for s in spans if s.name == "stage"]
    assert [s.t for s in stages] == [0, 1, 2]
    assert all(spans[s.parent].name == "stage" for s in spans
               if s.name in ("descend", "score_chain", "regression"))
    harvest = next(i for i, s in enumerate(spans) if s.name == "harvest")
    assert [s.name for s in spans if s.parent == harvest][:1] == ["harvest.wait"]
    assert sum(s.name == "nms" and s.parent == harvest for s in spans) == 2


@pytest.mark.parametrize("K,hw", [(32, None), (160, (120, 160))], ids=["nosplit", "split"])
def test_lane_carts_follow_the_counts(vga, K, hw):
    """`tail.lane_carts` is what `last_stats["counts"]` and run_fused's cart
    split imply (K=160 compacts after the first STAGE_SPLIT carts)."""
    if hw is None:
        counts, counters = vga["stats"]["counts"], vga["counters"]
    else:
        m = jt.synthetic_model(T=3, K=K, landmark_n=9, seed=4, reject_rate=0.15)
        det = jt.Detector(m, device="cpu")
        imgs = [make_image(hw[0], hw[1], s) for s in (1, 2)]
        _, _, counters = _recorded(lambda: det.detect_batch(imgs, th=-5.0))
        counts = det.last_stats["counts"]
        assert len(counts) == 4  # the split's compaction in both tail stages, one between
    assert counts[-1] > 0, "degenerate fixture"
    assert counters["tail.lane_carts"] == _lane_carts(counts, 3, K)


def test_plan_built_once_per_shape(vga):
    assert vga["first"]["plan.builds"] == 1
    assert "plan.builds" not in vga["counters"]


def test_nested_public_calls_are_one_call():
    m = jt.synthetic_model(T=2, K=8, landmark_n=9, seed=3, reject_rate=0.3)
    det = jt.Detector(m, device="cpu")
    img = make_image(60, 80, 5)
    _, spans, _ = _recorded(lambda: det.detect(img, th=-5.0))
    assert [(s.name, s.entry, s.B) for s in spans if s.name == "call"] == [("call", "detect", 1)]
    _, spans, _ = _recorded(lambda: det.detect_stream([img] * 3, batch=2, th=-5.0))
    assert [s.entry for s in spans if s.name == "call"] == ["detect_stream"]
    assert sum(s.name == "upload" for s in spans) == 2  # one per chunk


def test_cpp_detect_batch_spans():
    from jda_tpu_torch.cascador import CppDetector

    m = jt.synthetic_model(T=2, K=8, landmark_n=9, seed=3, reject_rate=0.05)
    cpp = CppDetector(m, jt.Config(fddb_detect_method=1, fddb_minimum_size=24,
                                   fddb_step=8), device="cpu")
    imgs = [make_image(72, 96, 5), make_image(72, 96, 6)]
    res, spans, counters = _recorded(lambda: cpp.detect_batch(imgs))
    assert sum(len(r[0]) for r in res) > 0, "degenerate fixture"
    assert [(s.entry, s.B) for s in spans if s.name == "call"] == [("cpp_detect_batch", 2)]
    names = [s.name for s in spans]
    harvest = names.index("harvest")
    assert spans[names.index("harvest.wait")].parent == harvest
    assert [spans[i].parent for i, n in enumerate(names) if n == "nms"] == [harvest] * 2
    assert names.count("plan") == 1 and counters["plan.builds"] == 1


def test_multi_scale_spans():
    """A multi-scale model's non-fused branch: `pyramid` once per image and
    `run_batch` once per geometry batch, both right under the call, the
    plain tail's spans inside `run_batch`, and the counters give the
    batches and the windows entering them.  Off, nothing is recorded."""
    m = jt.synthetic_model(T=2, K=8, landmark_n=9, seed=3, multi_scale=True, reject_rate=0.3)
    det = jt.Detector(m, device="cpu")
    imgs = [make_image(60, 80, 5), make_image(60, 80, 6)]
    off = det.detect_stream(imgs, batch=2, th=-5.0)
    assert tracing.drain() == ([], {})
    on, spans, counters = _recorded(lambda: det.detect_stream(imgs, batch=2, th=-5.0))
    assert sum(r.n for r in off) > 0, "degenerate fixture"
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        np.testing.assert_array_equal(a.scores, b.scores)
    assert {s.name for s in spans} <= NAMES and spans[0].entry == "detect_stream"
    n = len(enumerate_windows(80, 60, 1.25, 24, 60)[0])
    # two images of one geometry batch each, then one image in three batches
    three = _recorded(lambda: det.detect(imgs[0], th=-5.0, batch=n // 3 + 1))[1:]
    for (spans, counters), images, calls in (((spans, counters), 2, 1), (three, 1, 3)):
        names = [s.name for s in spans]
        assert names.count("pyramid") == images and names.count("run_batch") == images * calls
        assert all(s.parent == 0 for s in spans if s.name in ("pyramid", "run_batch"))
        assert all(spans[s.parent].name == "run_batch" for s in spans
                   if s.name in ("descend", "score_chain", "regression"))
        assert counters["run_batch.calls"] == images * calls
        assert counters["run_batch.windows"] == images * n


def test_drain_refuses_open_spans_and_counting_restores_off():
    tracing.start()
    with tracing.span("outer"):
        with pytest.raises(RuntimeError, match="open span"):
            tracing.drain()
    assert [s.name for s in tracing.drain()[0]] == ["outer"]
    tracing.stop()
    with tracing.counting() as n:
        with tracing.span("inner"):
            tracing.count("x", 2)
            tracing.count("x", 3)
    assert n == {"x": 5}
    tracing.count("x", 1)
    assert tracing.drain() == ([], {})


def test_counting_inside_a_trace_leaves_it_running():
    """counting() within a traced span: the trace keeps its spans and
    counts on, and the block gets only what it added."""
    tracing.start()
    tracing.count("x", 4)
    with tracing.span("outer"):
        with tracing.counting() as n:
            with tracing.span("inner"):
                tracing.count("x", 2)
                tracing.count("y", 0)
    tracing.count("x", 1)
    assert n == {"x": 2, "y": 0}
    spans, counters = tracing.drain()
    assert [s.name for s in spans] == ["outer", "inner"] and spans[1].parent == 0
    assert counters == {"x": 7, "y": 0}


def test_span_off_costs_under_a_microsecond():
    """A span and a counter with tracing off, less an empty loop: the least
    of 300 rounds of 1,000 each (reported with -s).  A round lasts well
    under a scheduler's time slice, so on a loaded machine most rounds run
    unpreempted and the least is the cost itself."""
    n = 1_000

    def per_call(fn):
        best = float("inf")
        for _ in range(300):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) / n)
        return best

    def spans():
        for _ in range(n):
            with tracing.span("stage", t=1):
                pass

    def counts():
        for _ in range(n):
            tracing.count("tail.lane_carts", 7)

    def empty():
        for _ in range(n):
            pass

    base = per_call(empty)
    span_s, count_s = per_call(spans) - base, per_call(counts) - base
    print(f"tracing off: span {span_s * 1e9:.0f} ns, count {count_s * 1e9:.0f} ns")
    assert span_s < 1e-6 and count_s < 1e-6
    assert tracing.drain() == ([], {})
