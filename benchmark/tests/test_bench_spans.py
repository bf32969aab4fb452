"""The program's spans against the device trace (benchmark/spans.py) on
hand-made intervals, and on the card the clock the two share."""

import pytest
import torch

from benchmark import spans as S
from jda_tpu_torch.tracing import Span


def span(name, start, end, parent=-1):
    return Span(name, start, end, parent, 0)


# a call [0, 100) with a stage [10, 60) holding a descend [20, 30) and a
# score chain [35, 50), then a harvest [70, 95) holding its wait [70, 90)
TREE = [span("call", 0, 100), span("stage", 10, 60, 0), span("descend", 20, 30, 1),
        span("score_chain", 35, 50, 1), span("harvest", 70, 95, 0),
        span("harvest.wait", 70, 90, 4)]


def test_self_ns():
    assert S.self_ns(TREE) == {"call": 100 - 50 - 25, "stage": 50 - 10 - 15, "descend": 10,
                               "score_chain": 15, "harvest": 5, "harvest.wait": 20}


def test_innermost_pieces():
    assert S.innermost(TREE) == [
        (0, 10, "call"), (10, 20, "stage"), (20, 30, "descend"), (30, 35, "stage"),
        (35, 50, "score_chain"), (50, 60, "stage"), (60, 70, "call"),
        (70, 90, "harvest.wait"), (90, 95, "harvest"), (95, 100, "call")]


def test_gap_split_over_two_spans_by_overlap():
    got = S.attribute_idle([(25, 40, "before add")], TREE)
    assert got == [("descend", 5e-9), ("stage", 5e-9), ("score_chain", 5e-9)]


def test_gap_outside_every_span_keeps_its_label():
    assert S.attribute_idle([(100, 130, "after the last operation: harvest")], TREE) == [
        ("after the last operation: harvest", 30e-9)]
    assert S.attribute_idle([(95, 110, "before copy")], TREE) == [
        ("call", 5e-9), ("before copy", 10e-9)]
    assert S.attribute_idle([(5, 9, "x")], []) == [("x", 4e-9)]


def test_nested_spans_give_the_innermost():
    assert S.attribute_idle([(72, 88, "before gather")], TREE) == [("harvest.wait", 16e-9)]


def test_idle_stretches_keep_the_device_labels():
    ops = [(10, 20, "a"), (15, 30, "b"), (40, 50, "c")]
    assert S.idle_stretches(ops, 0, 60) == [
        (0, 10, "call start: upload"), (30, 40, "before c"),
        (50, 60, "after the last operation: harvest")]


def test_span_sums():
    sums = S.SpanSums()
    ops = [(12, 18, "k1"), (36, 48, "k2"), (72, 74, "copy")]
    sums.add(TREE, {"tail.lane_carts": 40}, ops, 0, 110)
    sums.add(TREE, {"tail.lane_carts": 60}, ops, 0, 110)
    # idle per call: [0,12) [18,36) [48,72) [74,110): 12 + 18 + 24 + 36 = 90 ns
    assert sums.idle_total_s == pytest.approx(2 * 90e-9)
    assert sums.idle_s["after the last operation: harvest"] == pytest.approx(2 * 10e-9)
    assert sums.idle_in_spans() == pytest.approx(80 / 90)
    assert sums.counters == {"tail.lane_carts": 100}
    assert sums.self_ms(S.TAIL_SPANS) == pytest.approx(2 * (25 + 10 + 15) * 1e-6)
    assert sums.self_ms(S.API_SPANS) == pytest.approx(2 * (25 + 5) * 1e-6)
    assert S.tail_lane_use(75, 100) == 75.0
    assert S.tail_lane_use(0, 0) is None


@pytest.mark.cuda
def test_span_contains_its_kernel_on_the_card():
    """A span around a device sleep and a synchronise contains the sleep
    kernel's interval in the device profile: the two clocks agree to within
    the span's slack (printed with -s)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from jda_tpu_torch import tracing

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.start()
        with tracing.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()
        tracing.stop()
        spans, _ = tracing.drain()
    kernel = [(e.start_ns(), e.start_ns() + e.duration_ns())  # the sleep's spin kernel
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert len(kernel) == 1 and len(spans) == 1
    (k0, k1), s = kernel[0], spans[0]
    print(f"span opens {(k0 - s.start) / 1e6:.4f} ms before the kernel starts and closes "
          f"{(s.end - k1) / 1e6:.4f} ms after it ends")
    assert s.start <= k0 < k1 <= s.end
    assert k0 - s.start < 500_000 and s.end - k1 < 500_000
