"""Device-only profiling in cycles, summed in memory.

A traced run profiles the card alone (torch.profiler with the CUDA
activity only) over cycles of a few calls, reads each cycle's device
events straight from the profiler's results, adds them to running sums and
drops the cycle.  No trace is written to disk.  From the sums come the
device's busy time (the union of its operations' intervals), the kernels
launched, the time of the dense stage-0 filter's kernels, the operations
that took most time and the longest idle stretches by what followed them.
"""

from __future__ import annotations

import collections
import time
import warnings

from benchmark import yardstick as Y

# the dense stage-0 filter's kernels (jda_tpu_torch/csrc/dense0_walk.cuh)
DENSE0_KERNELS = ("head_kernel", "survivor_kernel")
NAME_CHARS = 96  # device operation names are cut to this length


def _short(name: str) -> str:
    """A device operation's name without its namespaces, cut short."""
    for ns in ("void ", "at::native::", "(anonymous namespace)::", "std::"):
        name = name.replace(ns, "")
    return name[:NAME_CHARS]


class DeviceTrace:
    """Running sums over profiled cycles."""

    def __init__(self):
        self.overhead_s = 0.0  # profiler start, stop and the reading of its events
        self.window_s = 0.0
        self.busy_s = 0.0
        self.kernels = 0
        self.dense0_s = 0.0
        self.op_s = collections.Counter()
        self.gap_s = collections.Counter()

    def cycle(self, fn):
        """Run `fn()` under the device profiler and add its events to the
        sums.  Returns what `fn` returns."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        c0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", message=".*clears events at the end of each cycle")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                w0, t0 = time.time_ns(), time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                w1, t1 = time.time_ns(), time.perf_counter()
        self.window_s += t1 - t0
        spans = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            name = e.name()
            s = e.start_ns()
            d = e.duration_ns()
            spans.append((s, s + d, name))
            self.op_s[_short(name)] += d / 1e9
            if not name.startswith(("Memcpy", "Memset")):
                self.kernels += 1
                if any(k in name for k in DENSE0_KERNELS):
                    self.dense0_s += d / 1e9
        self.busy_s += Y.union_seconds((s, e) for s, e, _ in spans)
        for label, sec in Y.idle_gaps(spans, w0, w1):
            self.gap_s[_short(label)] += sec
        self.overhead_s += time.perf_counter() - c0 - (t1 - t0)
        return out

    def breakdown(self):
        """The ten device operations that took most time and the ten
        longest idle kinds, as [name, seconds] lists."""
        return {
            "device_ops": [[k, v] for k, v in self.op_s.most_common(10)],
            "idle_gaps": [[k, v] for k, v in self.gap_s.most_common(10)],
        }
