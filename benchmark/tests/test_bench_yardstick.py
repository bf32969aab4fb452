"""The benchmark's arithmetic on made-up intervals and counts."""

import statistics
import types

import numpy as np
import pytest

from benchmark import harness as H
from benchmark import reference as R
from benchmark import yardstick as Y


def test_union_and_gaps():
    spans = [(10, 20, "a"), (15, 30, "b"), (40, 50, "c"), (45, 46, "d")]
    assert Y.union_seconds((s, e) for s, e, _ in spans) == pytest.approx(30e-9)
    gaps = Y.idle_gaps(spans, 0, 60)
    assert gaps == [("call start: upload", 10e-9), ("before c", 10e-9),
                    ("after the last operation: harvest", 10e-9)]
    assert Y.union_seconds([]) == 0


@pytest.mark.parametrize("p", [50, 90, 95])
def test_percentile(p):
    v = list(np.random.default_rng(p).exponential(size=137))
    assert Y.percentile(v, p) == pytest.approx(float(np.percentile(v, p)), rel=1e-12)


def test_quartile_spread():
    v = [10.0, 11.0, 9.0, 10.5, 9.5, 10.2]
    q = statistics.quantiles(v, n=4)
    assert Y.quartile_spread(v) == pytest.approx((q[2] - q[0]) / statistics.median(v))


def test_counted_ops():
    p = dict(visits=1000, finish=[10, 5, 0])
    config = dict(tree_depth=4, K=540, landmark_n=27)
    assert R.counted_ops(p, config) == 1000 * 16 + 15 * 540 * 54


def readings(**trace):
    t = types.SimpleNamespace(**dict(dict(window_s=2.0, busy_s=0.1, kernels=49_000, dense0_s=0.004), **trace))
    return H.Readings(setup_s=12.5, window_s=10.0, images=400, calls=25,
                      latencies_s=[0.3 + 0.001 * i for i in range(25)], trace=t,
                      dense0_bound_s=4e-5, traced_ops=2_000_000_000)


@pytest.mark.parametrize("name,want", [
    ("images_per_s", 40.0),
    ("setup_s", 12.5),
    ("latency_p50_ms", 312.0),
    ("latency_p90_ms", 321.6),
    ("device_idle_share.stream", 95.0),
    ("device_idle_share.b1", 95.0),
    ("launches_per_image.stream", 49_000 / 400),
    ("launches_per_call.b1", 49_000 / 25),
    ("dense0_roofline.stream", 1.0),
    ("dense0_roofline.b1", 1.0),
    ("mfu.stream", 100 * 2e9 / (2.0 * 67e12)),
    ("mfu.b1", 100 * 2e9 / (2.0 * 67e12)),
])
def test_metric_readers(name, want):
    assert H.metric_reader(name)(readings()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_idle_share.stream", "dense0_roofline.b1", "mfu.stream",
                                  "launches_per_image.stream", "launches_per_call.b1"])
def test_readers_find_nothing_without_a_trace(name):
    assert H.metric_reader(name)(H.Readings()) is None


def test_roofline_silent_without_its_kernels():
    assert H.metric_reader("dense0_roofline.stream")(readings(dense0_s=0.0)) is None
