#!/usr/bin/env python3
"""Detection throughput of jda_tpu_torch on a CUDA card against the C
reference on one CPU core: bench.py's workload, protocol and JSON line,
without JAX.

    python3 bench_torch.py [--device cuda|cpu]

The workload is bench.py's: VGA images (480x640, `make_image` from seeds
3, 4, ...) through `Detector.detect_stream` in chunks of BENCH_BATCH
(16), BENCH_CHUNKS (4) chunks, with the synthetic flagship-geometry model
(T=5, K=540, 27 landmarks, depth 4, seed 7, `realistic_drop_profile`) and
scale 1.25, min_size 24, max_size -1, th -0.5.  A warm pass over two
chunks comes first; then BENCH_REPS (3) interleaved runs of ours (every
image) and of the baseline (max(2, BATCH // 2) images), and the median of
each.  Unless BENCH_1080=0, 4 * BENCH_1080_BATCH (4) 1080p frames (seeds
31, 32, ...) follow on the same detector: a warm pass over two chunks,
then one timed stream.  A failure there raises: nothing is swallowed.
The detector reads the JDA_TPU_* knobs as it always does.

The baseline is the reference C (`jda_tpu_torch.oracle`) where its source
is mounted, else the in-tree C library (`jda_tpu_torch.native`, built from
native/jda_native.c, bit-identical to the reference C).  BASELINE.md's
baseline is one core, and that library parallelises detection with OpenMP
(`#pragma omp parallel for`), whose thread count is the calling thread's
OpenMP setting.  The OpenMP runtime is PyTorch's own, already started
when the library loads, so OMP_NUM_THREADS can no longer pin it: instead
`one_thread` sets the calling thread's count to 1 through the library's
runtime (`omp_set_num_threads`) around every baseline call, and restores
it after, which leaves PyTorch's own threads as they were.

Prints the card (nvidia-smi name and power limit) on stderr, then one JSON
line on stdout: bench.py's keys, `baseline` ("oracle" or "native") and the
VGA `batch`.
`--device` defaults to the card and raises without one; `--device cpu`
runs the plain PyTorch path.
"""

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

# bench.py's workload
H, W = 480, 640
HD_H, HD_W = 1080, 1920
KW = dict(scale=1.25, min_size=24, max_size=-1, th=-0.5)
MODEL = dict(T=5, K=540, landmark_n=27, seed=7)
IMAGE_SEED = 3
FRAME_SEED = 31
METRIC = "VGA images/sec, full detect (synthetic T=5 K=540 cascade)"


def make_image(h, w, seed):
    """Blocky texture plus noise (bench.make_image)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    noise = rng.normal(0, 12, (h, w))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def bench_model():
    from jda_tpu_torch import params as P

    return P.synthetic_model(
        **MODEL, drop_profile=P.realistic_drop_profile(MODEL["T"], MODEL["K"])
    )


@contextlib.contextmanager
def one_thread(lib):
    """The OpenMP thread count of the calling thread set to 1 through the
    OpenMP runtime `lib` links, and restored on exit."""
    lib.omp_get_max_threads.argtypes, lib.omp_get_max_threads.restype = [], ctypes.c_int
    lib.omp_set_num_threads.argtypes, lib.omp_set_num_threads.restype = [ctypes.c_int], None
    n = lib.omp_get_max_threads()
    lib.omp_set_num_threads(1)
    try:
        yield
    finally:
        lib.omp_set_num_threads(n)


class Baseline:
    """The C reference on one CPU core, over `model` saved in double into
    `tmpdir`: the oracle where available, else the native library."""

    def __init__(self, model, tmpdir):
        from jda_tpu_torch import native, oracle
        from jda_tpu_torch import params as P

        path = os.path.join(tmpdir, "bench.model")
        P.save_model(model, path, dtype="double")
        if oracle.available():
            self.name, self.det, self._omp = "oracle", oracle.Oracle(path, dtype="double"), None
        else:
            self.name, self.det = "native", native.NativeDetector(path, dtype="double")
            self._omp = native._load()

    def detect(self, img, **kw):
        if self._omp is None:
            return self.det.detect(img, **kw)
        with one_thread(self._omp):
            return self.det.detect(img, **kw)


def windows_per_image(h, w):
    """Windows of the bench ladder over one h x w image (max_size -1 is
    the image's short side, as Detector.detect takes it)."""
    from jda_tpu_torch.detect import enumerate_windows

    return len(enumerate_windows(w, h, KW["scale"], KW["min_size"], min(h, w))[0])


def run(det, imgs, frames, batch, reps, baseline, batch_1080=4):
    """bench.py's protocol over `imgs` (and `frames` at `batch_1080`, unless
    None) on the detector `det`, against `baseline` (an object with
    `.name` and `.detect(img, **KW)`).  Returns (the JSON line's dict,
    the detections of the last timed pass over `imgs`)."""
    if reps < 1:
        raise ValueError(f"bench_torch: BENCH_REPS must be at least 1, not {reps}")
    det.detect_stream(imgs[: 2 * batch], batch=batch, **KW)  # warm
    baseline.detect(imgs[0], **KW)  # warm, and the library's IO
    ours_runs, ref_runs = [], []
    n_ref = max(2, batch // 2)
    for _ in range(reps):
        t0 = time.perf_counter()
        res = det.detect_stream(imgs, batch=batch, **KW)
        ours_runs.append(len(imgs) / (time.perf_counter() - t0))
        t0 = time.perf_counter()
        for img in imgs[:n_ref]:
            baseline.detect(img, **KW)
        ref_runs.append(n_ref / (time.perf_counter() - t0))
    ours_ips = float(np.median(ours_runs))
    vs = ours_ips / float(np.median(ref_runs))
    wpi = windows_per_image(*imgs[0].shape)
    line = {
        "metric": METRIC,
        "value": round(ours_ips, 3),
        "unit": "images/sec",
        "vs_baseline": round(vs, 3),
        "windows_per_image": wpi,
        "windows_per_sec": round(ours_ips * wpi, 1),
        "runs_images_per_sec": [round(v, 3) for v in ours_runs],
        "ref_runs_images_per_sec": [round(v, 3) for v in ref_runs],
    }
    if frames is not None:
        w1080 = windows_per_image(*frames[0].shape)
        det.detect_stream(frames[: 2 * batch_1080], batch=batch_1080, **KW)  # warm
        t0 = time.perf_counter()
        det.detect_stream(frames, batch=batch_1080, **KW)
        s1080 = time.perf_counter() - t0
        line.update(
            p1080_stream_fps=round(len(frames) / s1080, 3),
            p1080_windows_per_frame=w1080,
            p1080_windows_per_sec=round(w1080 * len(frames) / s1080, 1),
        )
    line.update(baseline=baseline.name, batch=batch)
    return line, res


def card_line():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)
    from jda_tpu_torch.detect import Detector
    from jda_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    nchunk = int(os.environ.get("BENCH_CHUNKS", "4"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    batch_1080 = int(os.environ.get("BENCH_1080_BATCH", "4"))
    model = bench_model()
    imgs = [make_image(H, W, seed=IMAGE_SEED + i) for i in range(batch * nchunk)]
    frames = None
    if os.environ.get("BENCH_1080", "1") != "0":
        frames = [make_image(HD_H, HD_W, seed=FRAME_SEED + i) for i in range(4 * batch_1080)]
    det = Detector(model, device=device)
    if device.type == "cuda":
        print(card_line(), file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        line, _ = run(det, imgs, frames, batch, reps, Baseline(model, tmp), batch_1080)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
