"""The benchmark's arithmetic: the card's peaks, the least time of the
dense stage-0 filter, percentiles and spreads, and the device's busy time
from a trace.  Plain Python and numpy; nothing here reads the program."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def lbf_words(K: int) -> int:
    """32-bit words that hold a window's K stage-0 leaves at 4 bits each."""
    return -(-K // 8)


def ladder_bound(B, H, W, n_scales, n, K, node_n, nvis_sum, depth, lbf_bytes=0):
    """Least time of one dense stage-0 filter call over the ladder of B
    images of H x W (n windows each, n_scales scales): (bytes s, operations
    s).  Bytes: the images once, the per-scale node tables and the per-cart
    table, each window's score, alive flag and visit count, and the leaf
    words of the windows alive after stage 0.  Operations: per visited cart
    (depth-1) node steps of subtract, compare and two index operations, then
    add, subtract, divide and compare in the score chain."""
    bytes_moved = (
        B * H * W
        + n_scales * K * node_n * 16 + K * (node_n + 4) * 4 + n_scales * 16
        + B * n * (4 + 1 + 4)
        + lbf_bytes
    )
    ops = nvis_sum * ((depth - 1) * 4 + 4)
    return bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile (0 < p < 100) by linear interpolation between
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("percentile of no values")
    pos = (len(v) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def quartile_spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, with the quartiles of
    statistics.quantiles(values, n=4)."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def union_seconds(intervals: Iterable[Tuple[int, int]]) -> float:
    """Seconds covered by the union of (start ns, end ns) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e9


def idle_gaps(intervals: List[Tuple[int, int, str]], start_ns: int, end_ns: int):
    """The device's idle stretches inside [start_ns, end_ns] as (label,
    seconds): before the first operation ("call start: upload"), between
    two ("before <next operation>") and after the last ("after the last
    operation: harvest")."""
    out = []
    t = start_ns
    first = True
    for s, e, name in sorted(intervals):
        if s > t:
            label = "call start: upload" if first else f"before {name}"
            out.append((label, (s - t) / 1e9))
        first = False
        t = max(t, e)
    if end_ns > t:
        out.append(("after the last operation: harvest", (end_ns - t) / 1e9))
    return out
