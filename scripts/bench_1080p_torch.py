"""1080p single-frame latency and streaming FPS of jda_tpu_torch on a
CUDA card (scripts/bench_1080p.py's workload and JSON line, without JAX).

    python3 scripts/bench_1080p_torch.py [--device cuda|cpu]

The flagship-geometry synthetic model of bench_torch.py over 1920x1080
frames (`make_image` from seeds 31, 32, ...), scale 1.25, min_size 24,
max_size -1, th -0.5: latency at B=1 through `detect_batch` (one warm
call, then the median of 5), then the stream through `detect_stream` at
B1080_BATCH (2) over B1080_FRAMES (4 * B1080_BATCH) frames on a second
detector (a warm pass over two chunks, then one timed pass).

Prints one JSON line.  `--device` defaults to the card and raises without
one; `--device cpu` runs the plain PyTorch path.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np

import bench_torch as B  # noqa: E402


def run(model, frames, batch, device):
    """scripts/bench_1080p.py's measurement over `frames` at stream batch
    `batch`; returns the JSON line's dict."""
    from jda_tpu_torch.detect import Detector

    det = Detector(model, device=device)
    det.detect_batch(frames[:1], **B.KW)  # warm
    lat = []
    for i in range(5):
        t0 = time.perf_counter()
        det.detect_batch([frames[i % len(frames)]], **B.KW)
        lat.append(time.perf_counter() - t0)
    det2 = Detector(model, device=device)
    det2.detect_stream(frames[: 2 * batch], batch=batch, **B.KW)  # warm
    t0 = time.perf_counter()
    det2.detect_stream(frames, batch=batch, **B.KW)
    stream_s = time.perf_counter() - t0
    windows = B.windows_per_image(*frames[0].shape)
    return {
        "metric": "1080p detect",
        "sec_per_frame_b1": round(float(np.median(lat)), 3),
        "lat_runs": [round(v, 3) for v in lat],
        "stream_fps": round(len(frames) / stream_s, 3),
        "batch": batch,
        "frames": len(frames),
        "windows_per_frame": windows,
        "windows_per_sec_stream": round(windows * len(frames) / stream_s, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    from jda_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    batch = int(os.environ.get("B1080_BATCH", "2"))
    n = int(os.environ.get("B1080_FRAMES", str(4 * batch)))
    frames = [B.make_image(B.HD_H, B.HD_W, seed=B.FRAME_SEED + i) for i in range(n)]
    if device.type == "cuda":
        print(B.card_line(), file=sys.stderr, flush=True)
    line = run(B.bench_model(), frames, batch, device)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
