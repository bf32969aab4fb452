"""The benchmark of jda_tpu_torch, one cell per run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs the cell of BENCHMARK.json named <cell> on one CUDA card and prints,
as the last line of standard output, one JSON object: `correct`,
`attempted` (images sent in the window), `failed` (answers that differ
from the reference), `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device`, with --trace 1 `breakdown`,
and last `checks`, each number compared with its limit.  The same numbers
end standard error.  Exits non-zero, printing no result, without a card,
or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# the checkout root, in place of this directory (whose modules would shadow others)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_power_limit() -> str:
    """The card's power limit as nvidia-smi gives it, or "unknown"."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import harness as H

    c = H.resolve(H.load_spec(), args.workload)
    import torch

    # one client thread, and one intra-op thread for the program's host
    # work: its host time is kernel launches from this thread, and idle
    # intra-op threads spinning on the shared cores only widen the spread
    torch.set_num_threads(1)
    chips = int(c["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    line, numbers, memory_peak, r = H.run_cell(
        c, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = H.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                  memory_peak_bytes=memory_peak, power_limit=card_power_limit())
    if args.trace:
        device.update(busy_s=r.trace.busy_s, window_s=r.trace.window_s)
    line["device"] = device
    line["checks"] = {k: {"value": numbers[k], "limit": c["limits"][k]} for k in H.CHECKS}
    print(f"benchmark: {args.workload} seed {args.seed}: {r.calls} calls, {r.images} images "
          f"in {r.window_s:.3f} s, set-up {r.setup_s:.3f} s"
          + (f", profiler overhead {r.trace.overhead_s:.3f} s" if args.trace else ""),
          file=sys.stderr)
    for k in H.CHECKS:
        print(f"{k} {numbers[k]} limit {c['limits'][k]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
