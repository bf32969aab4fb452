"""Median time from a call to its result, over every call of the window (ms)."""

from benchmark.yardstick import percentile


def read(r):
    return 1e3 * percentile(r.latencies_s, 50)
