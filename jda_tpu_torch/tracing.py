"""Spans and counters inside the detection path, on the host's wall clock.

Off by default.  `start()` clears what was recorded and switches tracing
on; `drain()` returns `(spans, counters)` and clears them, leaving tracing
on; `stop()` switches it off.  `counting()` turns on the counters alone
for a block and gives back what the block added to them.  While tracing
is off, `span`, `call` and `count` cost one test of a module-level flag:
nothing is allocated, no clock is read and the device is never touched.  Tracing never
synchronises the device or launches a kernel; counters take integers the
host already holds (shapes, launch counts).

A span is a `Span`: its name, start and end in ns of `time.time_ns()`,
the index of the span open around it in the same drained list (-1 at the
top), the id shared by every span of one public call (-1 outside one),
and two small int attributes, the stage `t` and the images `B` (-1 where
not given); a `call` span also names its entry point.  `time.time_ns()`
is the clock the CUDA profiler (kineto) stamps its device events with, so
a span and a device operation compare directly.  Drain between public
calls, never inside a span.  There is one tracer per process, and spans
nest as calls do on the one host thread that drives the detector.

Spans of the detection path (name: where):

    call        a public entry (Detector.detect / detect_batch /
                detect_stream, CppDetector.detect / detect_batch); a
                nested public call opens none
    plan        the window ladder and its tables (cached)
    upload      images to the device;  upload.wait: the wait for the
                previous copy to have read the pinned buffer (inside
                `upload` or `pyramid`)
    dense0      the dense stage-0 filter's host checks and launches
    tail        the survivor tail kernel's host checks and launch (B; one
                per gather group, and one per image of a multi-scale model
                on the non-fused path, on a CUDA device, ops/tail.py)
    stage (t)   one stage of the plain tail, its compactions included
    compact     survivor compaction (waits in torch.nonzero for the device)
    descend     tree descent of a cart chunk
    score_chain the sequential score and rejection chain of a cart chunk
    regression  the exact per-stage shape regression
    harvest     the host post-pass of a batch;  harvest.wait: its first
                device-to-host read, which waits for the tail to finish
    nms         non-maximum suppression (with the C++ route's relocation)
    pyramid     the non-fused path's o/h/q levels of one image: for a
                multi-scale model the image's upload (alone, through the
                pinned buffer on a card) and the launch that builds h and
                q behind it (ops/pyramid.py; the plain twin on the CPU);
                for a single-scale model trivial 1x1 levels, stacked and
                uploaded
    run_batch   one geometry batch of the non-fused path's plain route
                for multi-scale and T == 0 models (`Detector._run_batch`:
                the CPU, and T == 0 models on a card); the plain tail's
                spans open inside it

Where the tail kernel runs, `stage`, `descend`, `score_chain` and
`regression` do not open for its lanes: they are the plain tail's (the
CPU, T == 1 models, `_run_batch`, training).

Counters: `plan.builds` (plans built on a cache miss), `tail.lane_carts`
(lanes x carts the plain tail's descent computed), `tail_kernel.launches`
and `tail_kernel.lanes` (the tail kernel's launches and the lanes queued
to it), `tail_kernel.ms_lanes` (the lanes queued to its multi-scale walk:
the multi-scale windows of the non-fused path on a card),
`dense0_filter.launches` and `dense0_image.launches` (kernels launched by
the two stage-0 filters), `pyramid_kernel.launches` (the o/h/q pyramid
kernel's launches: one an image of a multi-scale model on a card), `run_batch.calls` and `run_batch.windows` (the
non-fused branch's `_run_batch` calls and the windows entering them).  On
the multi-scale cell, ms_lanes / (ms_lanes + run_batch.windows) is the
share of windows the kernel walked.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, List, NamedTuple, Tuple


class Span(NamedTuple):
    name: str
    start: int  # ns, time.time_ns()
    end: int
    parent: int  # index in the drained list, -1 at the top
    call: int  # id of the public call it belongs to, -1 outside one
    t: int = -1  # stage
    B: int = -1  # images
    entry: str = ""  # a call span's entry point


_on = False  # spans and counters
_counting = False  # counters: on while _on is, or inside counting()
_records: List[list] = []  # [name, start, end, parent, call, t, B, entry]
_open: List[int] = []  # indices of the open spans, innermost last
_counters: Dict[str, int] = {}
_call = -1  # id of the open public call
_calls = 0


class _Off:
    """The span of tracing off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("rec", "opens_call")

    def __init__(self, name: str, t: int, B: int, entry: str):
        global _call, _calls
        self.opens_call = bool(entry)
        if self.opens_call:
            _call, _calls = _calls, _calls + 1
        parent = _open[-1] if _open else -1
        _open.append(len(_records))
        self.rec = [name, time.time_ns(), -1, parent, _call, t, B, entry]
        _records.append(self.rec)

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        global _call
        self.rec[2] = time.time_ns()
        _open.pop()
        if self.opens_call:
            _call = -1
        return False


def span(name: str, t: int = -1, B: int = -1):
    """A context manager that records the span `name` while tracing is on."""
    if not _on:
        return _OFF
    return _On(name, t, B, "")


def call(entry: str, B: int):
    """The `call` span of a public entry point over B images; inside an
    open call it records nothing, so a public call that calls another is
    one call."""
    if not _on or _call >= 0:
        return _OFF
    return _On("call", -1, B, entry)


def count(name: str, n: int) -> None:
    """Add the host integer n to the counter `name` while counting."""
    if _counting:
        _counters[name] = _counters.get(name, 0) + n


def _clear() -> None:
    global _call
    if _open:
        raise RuntimeError("tracing: spans are still open")
    _records.clear()
    _counters.clear()
    _call = -1


def start() -> None:
    """Clear the spans and counters and switch tracing on."""
    global _on, _counting
    _clear()
    _on = _counting = True


def stop() -> None:
    """Switch tracing off (what was recorded stays until start or drain)."""
    global _on, _counting
    _on = _counting = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans recorded since the last start or drain, in the order they
    opened, and the counters; both are cleared and tracing stays as it is.
    Raises RuntimeError inside an open span."""
    if _open:
        raise RuntimeError("tracing: drain inside an open span")
    spans = [Span(*r) for r in _records]
    counters = dict(_counters)
    _clear()
    return spans, counters


@contextlib.contextmanager
def counting() -> Iterator[Dict[str, int]]:
    """Counters on for the block, spans as they were; the dict it yields
    holds, when the block ends, what the block added to each counter.
    Tracing, its spans and its counters are left as they were, counted
    into as well where tracing is on."""
    global _counting
    was, before = _counting, dict(_counters)
    _counting = True
    got: Dict[str, int] = {}
    try:
        yield got
    finally:
        _counting = was
        got.update({k: v - before.get(k, 0) for k, v in _counters.items()
                    if before.get(k) != v})
        if not was:
            _counters.clear()
            _counters.update(before)
