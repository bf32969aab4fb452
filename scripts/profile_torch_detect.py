#!/usr/bin/env python3
"""Where the time goes in jda_tpu_torch's detection path, on one CUDA card.

    python3 scripts/profile_torch_detect.py [paths] [cost] [cells]
        [--cells a,b] [--calls N] [--out FILE]

Reads the program's own spans and counters (jda_tpu_torch/tracing.py)
beside a device-only profile, on the one clock both use.  Three parts
(all by default):

  paths  For the bench shapes (VGA at B=16, 1080p at B=4; T=5/K=540
         synthetic model with the realistic drop profile; scale 1.25, min
         24, th -0.5), the non-fused path (JDA_TPU_FUSED=0: the same model
         on one VGA image and one 1080p frame, a multi-scale model on one
         VGA image) and the C++-semantics path (CppDetector, the trained
         flagship model models/flagship_synth.model, VGA scenes with
         planted faces: detect_batch with method 1 at B=8, detect with
         method 1 and 0, a multi-scale model's method 0): one call
         unsynchronised without tracing, then one with tracing on, its
         host self time per span and its counters; then one call under the
         profiler: the device's busy time, the kernels launched (the
         stage-0 filters' from their counters), the idle share and the
         idle time put down to the innermost span open during it.
  cost   What tracing costs when on: bench's VGA stream (64 images,
         detect_stream at B=16) with tracing off and on in turns, RUNS
         runs each; and the kernels of one B=16 call with tracing off and
         on (tracing launches none).
  cells  The benchmark's cells (BENCHMARK.json, built by
         benchmark/harness.py from SEED): two warm calls, then N calls
         (--calls, default CALLS) each profiled in a cycle of its own as
         the benchmark's traced run does, with the program's spans: idle
         share, the share of idle time inside a span and inside `call`'s
         own time, idle by span, host ms of the survivor tail (the plain
         tail's spans and the kernel's `tail`) and of the detector API
         per image and per call, the tail's lane use against the
         reference's cart visits (plain tail), the tail kernel's
         launches and lanes a call, and the share of the multi-scale
         windows it walked (tail_kernel.ms_lanes against run_batch.windows).

Ends with the card's name and power limit; --out writes every reading to
FILE as JSON.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import make_image, make_scene  # noqa: E402

KW = dict(scale=1.25, min_size=24, max_size=-1, th=-0.5)
TOP = 8  # spans and idle labels printed per path
RUNS = 7  # runs each way of the cost part
SEED = 4011  # the cells part's pool and batches
# the survivor tail's spans: the plain tail's, and the kernel wrapper's
TAIL = ("stage", "descend", "score_chain", "regression", "tail")
CALLS = 12  # profiled calls per cell


def profiled(fn, on=True):
    """fn() under the device profiler, with tracing on (or off): (its
    result, the device operations [(start ns, end ns, name)], the window's
    bounds in ns, the spans and the counters)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jda_tpu_torch import tracing

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if on:
            tracing.start()
        w0 = time.time_ns()
        out = fn()
        torch.cuda.synchronize()
        w1 = time.time_ns()
        tracing.stop()
        spans, counters = tracing.drain()
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    return out, ops, w0, w1, spans, counters


def kernels(ops):
    return sum(not name.startswith(("Memcpy", "Memset")) for _, _, name in ops)


def traced(fn):
    """fn() unsynchronised with tracing on: (seconds, spans, counters)."""
    import torch

    from jda_tpu_torch import tracing

    torch.cuda.synchronize()
    tracing.start()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tracing.stop()
    return (dt,) + tracing.drain()


def busy_s(ops):
    from benchmark import yardstick as Y

    return Y.union_seconds((s, e) for s, e, _ in ops)


def clock_check():
    """A span around a device sleep, and the kineto interval of that
    kernel: (kernel start - span start, span end - kernel end) in ms."""
    import torch

    from jda_tpu_torch import tracing

    def sleep():
        with tracing.span("sleep"):
            torch.cuda._sleep(20_000_000)
            torch.cuda.synchronize()

    torch.cuda._sleep(1000)  # warm
    _, ops, _, _, spans, _ = profiled(sleep)
    sp = next(s for s in spans if s.name == "sleep")
    (k,) = ops  # the sleep's spin kernel
    return (k[0] - sp.start) / 1e6, (sp.end - k[1]) / 1e6


def path_cells():
    import jda_tpu_torch as jt
    from jda_tpu_torch.cascador import CppDetector

    model = jt.synthetic_model(
        T=5, K=540, landmark_n=27, seed=7,
        drop_profile=jt.realistic_drop_profile(5, 540),
    )
    det = jt.Detector(model)
    ms_det = jt.Detector(jt.synthetic_model(
        T=5, K=540, landmark_n=27, seed=7, multi_scale=True,
        drop_profile=jt.realistic_drop_profile(5, 540),
    ))
    flag = jt.load_model(os.path.join(ROOT, "models", "flagship_synth.model"))
    cpp1 = CppDetector(flag, jt.Config(fddb_detect_method=1))
    cpp0 = CppDetector(flag, jt.Config(fddb_detect_method=0))
    cpp_ms = CppDetector(ms_det.params, jt.Config(fddb_detect_method=0))
    scenes = [make_scene(480, 640, seed=200 + i)[0] for i in range(8)]

    def c_api(d, h, w, B, seed, unfused):
        imgs = [make_image(h, w, seed + i) for i in range(B)]
        if unfused:
            return lambda: [d.detect(g, **KW) for g in imgs]
        return lambda: d.detect_batch(imgs, **KW)

    return (
        ("VGA B=16", det, c_api(det, 480, 640, 16, 3, False), False),
        ("1080p B=4", det, c_api(det, 1080, 1920, 4, 31, False), False),
        ("non-fused VGA, 1 image", det, c_api(det, 480, 640, 1, 3, True), True),
        ("non-fused 1080p, 1 frame", det, c_api(det, 1080, 1920, 1, 31, True), True),
        ("non-fused multi-scale VGA, 1 image", ms_det,
         c_api(ms_det, 480, 640, 1, 3, True), True),
        ("C++ method 1, detect_batch VGA B=8", cpp1.det,
         lambda: cpp1.detect_batch(scenes), False),
        ("C++ method 1, detect, 1 VGA image", cpp1.det,
         lambda: cpp1.detect(scenes[0]), False),
        ("C++ method 0, detect, 1 VGA image", cpp0.det,
         lambda: cpp0.detect(scenes[0]), False),
        ("C++ multi-scale method 0, detect, 1 VGA image", cpp_ms.det,
         lambda: cpp_ms.detect(scenes[0]), False),
    )


def paths_part():
    import torch

    from benchmark import spans as S

    out = {}
    for label, d, run, unfused in path_cells():
        os.environ["JDA_TPU_FUSED"] = "0" if unfused else "1"
        d.last_stats = {}
        run()  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        plain = time.perf_counter() - t0
        dt, spans, counters = traced(run)
        selfs = S.self_ns(spans)
        _, ops, w0, w1, pspans, pcounters = profiled(run)
        sums = S.SpanSums()
        sums.add(pspans, pcounters, ops, w0, w1)
        wall = (w1 - w0) / 1e9
        busy = busy_s(ops)
        dense = (pcounters.get("dense0_filter.launches", 0)
                 + pcounters.get("dense0_image.launches", 0))
        print(f"{label}: {plain * 1e3:.1f} ms unsynchronised, {dt * 1e3:.1f} ms traced; "
              f"counts {d.last_stats.get('counts', 'n/a')}; counters {dict(counters)}")
        for name, ns in sorted(selfs.items(), key=lambda kv: -kv[1])[:TOP]:
            print(f"  {name:14s} self {ns / 1e6:9.2f} ms  {100 * ns / 1e9 / dt:5.1f} %")
        print(f"  profiler: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
              f"({kernels(ops)} kernels, {dense} of them the stage-0 filters'), idle "
              f"share {1 - busy / wall:.3f}, {100 * sums.idle_in_spans():.1f} % of the idle "
              f"time inside a span; idle by span: "
              + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                          sorted(sums.idle_s.items(), key=lambda kv: -kv[1])[:TOP]))
        out[label] = dict(plain_ms=plain * 1e3, traced_ms=dt * 1e3,
                          self_ms={k: v / 1e6 for k, v in selfs.items()},
                          counters=counters, wall_ms=wall * 1e3, busy_ms=busy * 1e3,
                          kernels=kernels(ops), idle_in_spans=sums.idle_in_spans(),
                          idle_ms={k: v * 1e3 for k, v in sums.idle_s.items()})
    os.environ.pop("JDA_TPU_FUSED", None)
    return out


def cost_part():
    """Bench's VGA stream with tracing off and on, in turns (off first in
    odd pairs, on first in even ones)."""
    import torch

    import jda_tpu_torch as jt
    from jda_tpu_torch import tracing

    det = jt.Detector(jt.synthetic_model(
        T=5, K=540, landmark_n=27, seed=7,
        drop_profile=jt.realistic_drop_profile(5, 540),
    ))
    imgs = [make_image(480, 640, seed=i) for i in range(64)]

    def run(on):
        if on:
            tracing.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect_stream(imgs, batch=16, **KW)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tracing.stop()
        spans = len(tracing.drain()[0])
        return dt, spans

    run(False)
    run(True)  # warm
    kern = {on: kernels(profiled(lambda: det.detect_batch(imgs[:16], **KW), on)[1])
            for on in (False, True)}
    secs = {False: [], True: []}
    n_spans = 0
    for i in range(RUNS):
        for on in ((False, True) if i % 2 == 0 else (True, False)):
            dt, n = run(on)
            secs[on].append(dt)
            n_spans = max(n_spans, n)
    off, on = statistics.median(secs[False]), statistics.median(secs[True])
    q = {k: statistics.quantiles(v, n=4) for k, v in secs.items()}
    res = dict(kernels_off=kern[False], kernels_on=kern[True],
               off_s=secs[False], on_s=secs[True], off_median=off, on_median=on,
               on_cost=on / off - 1, spans_per_run=n_spans,
               off_spread=(q[False][2] - q[False][0]) / off,
               on_spread=(q[True][2] - q[True][0]) / on)
    print(f"tracing cost, VGA stream of 64 images at B=16, {RUNS} runs each in turns "
          f"(kernels of one B=16 call: off {kern[False]}, on {kern[True]}): "
          f"off {off:.4f} s (spread {res['off_spread']:.3f}), on {on:.4f} s (spread "
          f"{res['on_spread']:.3f}), {100 * res['on_cost']:+.2f} %, {n_spans} spans a run; "
          f"off {['%.4f' % v for v in secs[False]]}, on {['%.4f' % v for v in secs[True]]}")
    return res


def ms_share(counters):
    """tail_kernel.ms_lanes over it plus run_batch.windows, or None where
    neither was counted."""
    ms = counters.get("tail_kernel.ms_lanes", 0)
    total = ms + counters.get("run_batch.windows", 0)
    return ms / total if total else None


def cells_part(names, calls=CALLS):
    import torch

    from benchmark import harness as H
    from benchmark import spans as S

    spec = H.load_spec()
    out = {}
    for name in names:
        c = H.resolve(spec, name)
        config, traffic = c["config"], c["traffic"]
        fields = H.model_fields(config)
        pool = H.make_pool(traffic, SEED)
        batches = H.batches(traffic)
        program = H.Program(config, traffic, fields, "cuda")
        for idx in batches[:2]:  # warm-up, as the benchmark's
            program.call(list(pool[idx]))
        sums = S.SpanSums()
        window = busy = 0.0
        n_kernels = images = 0
        served = []
        for i in range(calls):
            idx = batches[i % len(batches)]
            imgs = list(pool[idx])
            _, ops, w0, w1, spans, counters = profiled(lambda: program.call(imgs))
            sums.add(spans, counters, ops, w0, w1)
            window += (w1 - w0) / 1e9
            busy += busy_s(ops)
            n_kernels += kernels(ops)
            images += len(idx)
            served.append(idx)
        del program
        torch.cuda.empty_cache()
        _, per, _ = H.reference(config, traffic, fields, pool, "cuda")
        # the multi-scale reference counts no stage-0 visits apart: its
        # path has no dense filter, so the plain tail descends every visit
        tail_visits = sum(per[j]["visits"] - per[j].get("visits0", 0)
                          for idx in served for j in idx)
        idle = sums.idle_total_s
        r = dict(
            seed=SEED, calls=calls, images=images, window_s=window, busy_s=busy,
            idle_share=idle / window, idle_in_spans=sums.idle_in_spans(),
            idle_in_call_self=sums.idle_s.get("call", 0.0) / idle if idle else 0.0,
            kernels_per_image=n_kernels / images, kernels_per_call=n_kernels / calls,
            tail_host_ms_per_image=sums.self_ms(TAIL) / images,
            tail_host_ms_per_call=sums.self_ms(TAIL) / calls,
            api_host_ms_per_image=sums.self_ms(S.API_SPANS) / images,
            api_host_ms_per_call=sums.self_ms(S.API_SPANS) / calls,
            tail_lane_use=S.tail_lane_use(tail_visits, sums.counters.get("tail.lane_carts", 0)),
            tail_visits=tail_visits, lane_carts=sums.counters.get("tail.lane_carts", 0),
            tail_kernel_launches_per_call=sums.counters.get("tail_kernel.launches", 0) / calls,
            tail_kernel_lanes_per_call=sums.counters.get("tail_kernel.lanes", 0) / calls,
            # the multi-scale windows the kernel walked, of all the non-fused
            # path's multi-scale windows (the rest went through _run_batch)
            ms_kernel_share=ms_share(sums.counters),
            self_ms_per_call={k: 1e3 * v / calls for k, v in sums.self_s.items()},
            idle_s=dict(sorted(sums.idle_s.items(), key=lambda kv: -kv[1])),
            counters=dict(sums.counters),
        )
        print(f"{name} (seed {SEED}, {calls} profiled calls): " + json.dumps(
            {k: v for k, v in r.items() if not isinstance(v, dict)}))
        print("  idle by span (s): " + ", ".join(
            f"{k} {v:.4f}" for k, v in list(r["idle_s"].items())[:10]))
        print("  self ms per call: " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(r["self_ms_per_call"].items(),
                                                key=lambda kv: -kv[1])))
        out[name] = r
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parts", nargs="*", choices=("paths", "cost", "cells"),
                    help="parts to run (default all)")
    ap.add_argument("--cells", default="", help="cells of BENCHMARK.json (default all)")
    ap.add_argument("--calls", type=int, default=CALLS, help="profiled calls per cell")
    ap.add_argument("--out", help="a JSON file for every reading")
    args = ap.parse_args(argv)
    parts = args.parts or ["paths", "cost", "cells"]
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_detect: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # as the benchmark runs the program
    result = {}
    first, last = clock_check()
    result["clock_ms"] = dict(kernel_start_after_span_start=first,
                              span_end_after_kernel_end=last)
    print(f"clock: a span around a 20 M-cycle device sleep opens {first:.4f} ms before "
          f"the kernel starts and closes {last:.4f} ms after it ends")
    if "paths" in parts:
        result["paths"] = paths_part()
    if "cost" in parts:
        result["cost"] = cost_part()
    if "cells" in parts:
        from benchmark import harness as H

        names = args.cells.split(",") if args.cells else [
            w["name"] for w in H.load_spec()["workloads"]]
        result["cells"] = cells_part(names, args.calls)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    result["card"] = card
    result["torch"] = torch.__version__
    print(card, torch.__version__)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
