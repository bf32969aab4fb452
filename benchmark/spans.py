"""The program's spans against the device trace.

Spans are `jda_tpu_torch.tracing.Span`s as `tracing.drain()` returns them
(name, start and end in ns of `time.time_ns()`, the index of the parent
span), the clock the device profiler stamps its events with.  From them:

  * each span name's self time (its duration minus its children's);
  * the device's idle stretches, each split over the innermost spans open
    during it, by overlap; the part no span covers keeps the label the
    device trace gives it (what ran next on the device);
  * the per-layer readings built from both: the survivor tail's and the
    detector API's host milliseconds, and the share of the lane-carts the
    tail computes that are cart visits of the reference.

Plain Python; nothing here imports the program or the device.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Sequence, Tuple

# self time of these spans is the survivor tail's host time
TAIL_SPANS = ("stage", "descend", "score_chain", "regression")
# and of these the detector API's (the *.wait spans and the tail excluded)
API_SPANS = ("call", "plan", "upload", "harvest", "nms")


def self_ns(spans: Sequence) -> Dict[str, int]:
    """Each span name's self time in ns: the durations of its spans minus
    the durations of their children."""
    out: Dict[str, int] = collections.Counter()
    for s in spans:
        d = s.end - s.start
        out[s.name] += d
        if s.parent >= 0:
            out[spans[s.parent].name] -= d
    return out


def idle_stretches(intervals: Iterable[Tuple[int, int, str]], start_ns: int,
                   end_ns: int) -> List[Tuple[int, int, str]]:
    """The device's idle stretches inside [start_ns, end_ns] as (start ns,
    end ns, label), labelled as yardstick.idle_gaps labels them: before the
    first operation, between two and after the last."""
    out = []
    t = start_ns
    first = True
    for s, e, name in sorted(intervals):
        if s > t:
            out.append((t, s, "call start: upload" if first else f"before {name}"))
        first = False
        t = max(t, e)
    if end_ns > t:
        out.append((t, end_ns, "after the last operation: harvest"))
    return out


def innermost(spans: Sequence) -> List[Tuple[int, int, str]]:
    """The time the spans cover, cut into sorted, disjoint (start ns, end
    ns, name) pieces, each under the innermost span open during it.  Spans
    nest (one host thread), so a child lies inside its parent."""
    out: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []  # (end, name) of the open spans
    t = 0

    def close_until(when):
        nonlocal t
        while stack and stack[-1][0] <= when:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for s in sorted(spans, key=lambda s: (s.start, -s.end)):
        close_until(s.start)
        if stack and s.start > t:
            out.append((t, s.start, stack[-1][1]))
        t = s.start
        stack.append((s.end, s.name))
    close_until(float("inf"))
    return out


def attribute_idle(gaps: Iterable[Tuple[int, int, str]], spans: Sequence
                   ) -> List[Tuple[str, float]]:
    """Each idle stretch (start ns, end ns, label) split over the innermost
    spans open during it, by overlap, as (span name, seconds); the part no
    span covers keeps the stretch's label."""
    pieces = innermost(spans)
    starts = [p[0] for p in pieces]
    out = []
    for g0, g1, label in gaps:
        covered = 0
        i = max(bisect.bisect_right(starts, g0) - 1, 0)
        while i < len(pieces) and pieces[i][0] < g1:
            lo, hi = max(g0, pieces[i][0]), min(g1, pieces[i][1])
            if hi > lo:
                out.append((pieces[i][2], (hi - lo) / 1e9))
                covered += hi - lo
            i += 1
        if g1 - g0 > covered:
            out.append((label, (g1 - g0 - covered) / 1e9))
    return out


class SpanSums:
    """Running sums over traced calls: self seconds per span name, idle
    seconds per span name (or device label), and the program's counters."""

    def __init__(self):
        self.self_s: Dict[str, float] = collections.Counter()
        self.idle_s: Dict[str, float] = collections.Counter()
        self.counters: Dict[str, int] = collections.Counter()
        self.idle_total_s = 0.0

    def add(self, spans: Sequence, counters: Dict[str, int],
            device_intervals: Iterable[Tuple[int, int, str]], start_ns: int, end_ns: int):
        """One traced call: its drained spans and counters, and the device
        operations (start ns, end ns, name) of the window [start_ns,
        end_ns] that the call ran in."""
        for name, ns in self_ns(spans).items():
            self.self_s[name] += ns / 1e9
        self.counters.update(counters)
        for label, sec in attribute_idle(idle_stretches(device_intervals, start_ns, end_ns),
                                         spans):
            self.idle_s[label] += sec
            self.idle_total_s += sec

    def self_ms(self, names: Sequence[str]) -> float:
        return 1e3 * sum(self.self_s.get(n, 0.0) for n in names)

    def idle_in_spans(self) -> float:
        """Share of the idle seconds that fall inside a program span."""
        if self.idle_total_s <= 0:
            return 0.0
        outside = sum(v for k, v in self.idle_s.items() if k not in self.self_s)
        return 1.0 - outside / self.idle_total_s


def tail_lane_use(tail_visits: int, lane_carts: int):
    """Share (%) of the lane-carts the tail's descent computed that are cart
    visits of the reference after stage 0 (sum of visits - visits0 over
    the same images); None without lane-carts."""
    if lane_carts <= 0:
        return None
    return 100.0 * tail_visits / lane_carts
