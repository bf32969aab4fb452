"""A/B the detection pipeline's tail, canvas and batch knobs of
jda_tpu_torch on a CUDA card (scripts/tune_detect.py's matrices, without
JAX).

    python3 scripts/tune_detect_torch.py [quick|full] [bench_torch.py arguments]

Runs bench_torch.py once per configuration, each in a subprocess under its
environment (BENCH_REPS defaults to 2), and prints a line per
configuration, with the tail, canvas and batch its JSON line reports (so
labels that name the same configuration show as such: JDA_TPU_CANVAS
alone selects no canvas tail, and BENCH_BATCH defaults to 16), and the
best; a configuration whose run fails is printed as
FAILED with the tail of its output.  Exits non-zero when every
configuration failed.
"""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUICK = [
    # (label, env)
    ("v1 gather tail B=8", {"JDA_TPU_TAIL": "gather"}),
    ("mxu canvas=gather B=8", {"JDA_TPU_CANVAS": "gather"}),
    ("mxu canvas=rows B=8", {"JDA_TPU_CANVAS": "rows"}),
]

FULL = QUICK + [
    ("v1 gather tail B=16", {"JDA_TPU_TAIL": "gather", "BENCH_BATCH": "16", "BENCH_CHUNKS": "4"}),
    ("mxu canvas=rows B=16", {"JDA_TPU_CANVAS": "rows", "BENCH_BATCH": "16", "BENCH_CHUNKS": "4"}),
    ("v1 gather tail B=32", {"JDA_TPU_TAIL": "gather", "BENCH_BATCH": "32", "BENCH_CHUNKS": "2"}),
]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    mode = argv.pop(0) if argv and argv[0] in ("quick", "full") else "quick"
    rows = []
    for label, env in QUICK if mode == "quick" else FULL:
        e = dict(os.environ)
        e.update(env)
        e.setdefault("BENCH_REPS", "2")
        p = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench_torch.py"), *argv],
            env=e,
            capture_output=True,
            text=True,
            timeout=1800,
        )
        line = [l for l in p.stdout.splitlines() if l.startswith("{")]
        if p.returncode != 0 or not line:
            print(f"{label:28s}  FAILED rc={p.returncode}")
            tail = (p.stderr or p.stdout).splitlines()[-8:]
            print("   " + "\n   ".join(tail))
            continue
        d = json.loads(line[-1])
        rows.append((label, d))
        print(
            f"{label:28s}  {d['value']:7.2f} img/s  vs_ref {d.get('vs_baseline')}"
            f"  runs {d.get('runs_images_per_sec')}"
            f"  (tail {d['tail']}, canvas {d['canvas']}, B={d['batch']})",
            flush=True,
        )
    if not rows:
        return 1
    best = max(rows, key=lambda r: r[1]["value"])
    print(f"\nbest: {best[0]} at {best[1]['value']} img/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
