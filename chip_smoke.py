#!/usr/bin/env python3
"""Drive jda_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. build the CUDA kernels from jda_tpu_torch/csrc/ (one nvcc per source,
     all at once) and print the card;
  2. hold the dense stage-0 kernel (`dense0_filter`), through its per-scale
     entry, against its plain PyTorch version on every VGA scale at B=16 and
     on 1080p win 24, 57 and 88 at B=4, with and without packed leaf words:
     score, alive and nvis bit-equal, leaf words equal where alive;
  3. the main path: Detector.detect_stream over 4 chunks of 16 VGA images
     (a warm pass, then a timed pass) with the bench model (T=5, K=540,
     27 landmarks, depth 4, realistic drop profile), counting kernel
     launches and plans built (none: the warm pass built them);
  4. the same model against the native C library on 2 VGA images:
     identical boxes, scores within 2e-4, shapes within 2e-3;
  5. a 1080p stream of 4 frames at B=4;
  6. `dense0_filter` per VGA batch and per 1080p batch (CUDA events) beside
     its plain version (both batches), its bound and the 14 per-scale calls
     that compute the same; the time of its head and survivor phases, the survivor
     queue's length, the share of windows alive after 8, 16, 32 and 64
     carts, and for both batches the time at each of those head lengths,
     the outputs held bit-equal to those of the head length in use;
  7. hold the whole-ladder kernel of one image (`dense0_image`) against its
     plain version and against `dense0_filter` at B=1 on the full VGA
     ladder (4 images) and the full 1080p ladder (1 frame): score, alive
     and nvis bit-equal;
  8. the non-fused path at full width: Detector.detect under
     JDA_TPU_FUSED=0 on 4 VGA images and 1 1080p frame, bit-equal to the
     fused results of phases 3 and 5, one `dense0_image` call (two kernels)
     per image;
  9. a multi-scale model of the same width through Detector.detect
     (the pyramid kernel, then the tail kernel's level walk of the whole
     ladder, one launch of each an image, counted) on 2 VGA images: the
     full ladder bit-equal to the
     port on the CPU (`_run_batch`), and against the
     native C library with the window pinned to 24 px, where every read of
     the C library stays inside its pyramid: identical boxes, scores within
     2e-4, shapes within 2e-3;
 10. `dense0_image` per VGA image and per 1080p frame (CUDA events) beside
     its plain version, its bound and the 14 per-scale `dense0_filter`
     calls at B=1 that compute the same; its own two phases, queue length
     and times at head lengths 8, 16, 32 and 64, as in phase 6;
 11. (run after phase 2, whose plain results it reuses) hold the
     whole-ladder batch entry of `dense0_filter` against the plain version
     on the full VGA ladder at B=16, the full 1080p ladder at B=4 and a
     batch of four images of different sizes, with and without leaf words,
     and that batch through `detect_batch` against each image alone;
 12. the C++-semantics path's tables, with the trained flagship model
     (models/flagship_synth.model: T=5, K=540, 27 landmarks, depth 4) on
     VGA scenes of `make_scene` (`make_image` with three planted faces):
     `dense0_filter` against its plain version on the method-1 ladder at
     B=8 (rounding tables, windows from 20 px at a fixed step of 5, 13
     scales) and on the banded method-0 canvases of one VGA image and of
     one 1080p frame (pyramid levels packed as bands, shifted tables);
     `dense0_image` on the method-1 ladder of one image; each timed (CUDA
     events) beside its plain version and its bound;
 13. CppDetector.detect_batch with method 1 at B=8 (a warm pass, then a
     timed pass: two `dense0_filter` launches), and CppDetector.detect with
     method 1 (two `dense0_image` launches per image) and method 0 (two
     `dense0_filter` launches per image) on 2 images each: bit-equal to the
     same detector on the CPU, every planted face found;
 14. a multi-scale model of the same width through method 0's dense
     multi-scale path (the plain filter; no kernel) on one image, bit-equal
     to the CPU port;
 15. run_fddb over a temporary two-fold FDDB folder of 16 scenes fed
     through imread=, for both methods: img/s, windows and mean reject
     carts, fold 1 equal to phase 13's batch;
 16. training at the flagship geometry (scripts/train_flagship.py:453-484:
     K=540, 27 landmarks, depth 4, F=2,000, patches 48/36/24, seed 11; cut
     to T=1): Trainer.train() from empty_model with its cursor at (0, 531),
     so the stage's last 8 carts are trained, negatives mined by the device
     miner, scores normalised at cart 540 and the global regression solved
     at full width (LBF 4,320 -> 54), on 1,024 faces of `train_corpus`
     and 12 `make_image` backgrounds, on the card and on the CPU: every
     model field but W equal, W within W_REL_TOL of max |W|, live masks,
     weights, mined rows and the random stream equal;
 17. the same on the flagship's 16,384 faces on the card, timed: seconds
     per cart, split search per node, one cart step under torch.profiler
     (device events, idle share), the first mining event (windows screened
     per second, host rebuild and revalidation), gen_lbf and the ridge
     solve, mean error before and after the regression;
 18. the model of phase 17 saved as doubles and loaded, through
     CppDetector.detect_batch with method 1 on 8 `make_scene` images: two
     `dense0_filter` launches, bit-equal to the same on the CPU;
 19. the hard-pool miners at the flagship geometry on phase 16's faces and
     backgrounds: Trainer.train() from `empty_model` at cursor (0, 535)
     (carts 536..539) with a starved scan (2 scan states, 2 batches of 128
     windows) and both factories registered (`hard_canvas` and
     `near_miss`, numpy models of scripts/train_flagship.py's), (a) with
     the canvas top-up and (b) with JDA_TPU_CANVAS_MINER=0 and the hard
     factory's, each on the card and on the CPU: every model field but W
     equal, W within W_REL_TOL of max |W|, live masks, the negatives' rows,
     scores and shapes, the difficulty, the cursors and the random stream
     equal; at least two mining events, a later one under the scan cut;
     each top-up timed (windows or candidates screened per second, host
     render, host rebuild and revalidation, the difficulty after it);
 20. the multi-device paths (jda_tpu_torch.entry.run_on_mesh: spawned
     processes, one per rank, a 1-D "dp" DeviceMesh), each run fatal on
     failure: (a) one rank over NCCL, Trainer(mesh=) on phase 17's 16,384
     faces: every model field equal to phase 17's, W included, live masks
     and the random stream too; seconds per cart against phase 17's, the
     collectives' count, bytes and share of a node, the largest exact sum;
     (b) two ranks on the one card over gloo, Trainer(mesh=) on phase 16's
     1,024 faces: both equal to phase 16's card model in every field, W
     included; (c) detect_batch(mesh=) at one rank over NCCL on phase 3's
     VGA B=16 batch at full width, bit-equal to phase 3's results with two
     `dense0_filter` launches, and on 17 VGA images at two ranks over gloo,
     equal to the same images without a mesh, two launches per rank; (d)
     dryrun_multichip(1) (NCCL) and dryrun_multichip(2, backend="gloo");
 21. (none: the port has no canvas tail to check; the later phases keep
     their numbers)
 22. the flagship workflow (scripts/train_flagship_torch.py,
     scripts/eval_synth_scenes_torch.py), each part fatal on failure:
     (a) SHA-256 digests of the flagship generators' output (64 make_face
     from seed 7, 8 make_bg tiles, make_near_miss at difficulties 0, 0.5
     and 1 in every mode, 16 make_hard_canvas, the 24 evaluation scenes)
     equal to GENERATOR_DIGESTS, recorded from scripts/train_flagship.py
     with OpenCV, so numpy without OpenCV gives the same bytes here;
     (b) the scene evaluation of models/flagship_synth.model:
     Detector(rounding=True).detect_stream over the 24 scenes at B=8, every
     point of the sweep equal to models/scene_eval.json (tp, fp, faces and
     recall exactly, the alignment error within 1e-6), the first 8 scenes
     bit-equal to the port on the CPU, two `dense0_filter` launches per
     batch, img/s; (c) stage 5 of the flagship resumed from the in-tree
     snapshot pair through the script's resume path (make_bg, make_near_miss
     and make_hard_canvas registered, mining capped by
     --mining-max-batches), RESUME_CARTS carts on the card and on the CPU:
     every model field (W untouched), the live masks, the negatives, the
     mined rows, scores and shapes, the factories' cursors and difficulty
     and the next draw equal; seconds per cart, and per mining event the
     windows screened per second and the host's seconds;
 23. the held-out and FDDB-format evaluations (scripts/eval_holdout_torch.py,
     scripts/synth_fddb_torch.py, jda_tpu_torch/jpeg.py), each part fatal
     on failure: (a) SHA-256 digests of the six families' scenes and truths
     (perturbed families from HOLDOUT_SEEDS), all six equal to
     HOLDOUT_DIGESTS, recorded from scripts/eval_holdout.py with OpenCV;
     (b) the six sweeps of models/flagship_synth.model on
     the card (24 scenes each at B=8, th -3, ladder 1.25): two
     `dense0_filter` launches per batch, base and texture_bg equal to
     models/scene_eval_holdout.json at every point, the first 8 scenes of
     each family bit-equal to the port on the CPU, img/s; (c) the 48
     in-tree JPEGs of data/fddb_synth decoded by jpeg.imread_gray equal to
     JPEG_DIGESTS (OpenCV's gray reads), fold 1's first 4 scenes encoded
     byte-equal to the in-tree files, host seconds per image for each;
     (d) run_fddb with method 1 over a copy of data/fddb_synth read by
     jpeg.imread_gray: 12 `dense0_filter` launches, fold outputs equal to
     data/fddb_synth/result (rects exact, scores within 2e-4), the discROC
     points equal, img/s;
 24. the measurement entry points, each part fatal on failure: (a)
     bench_torch.run in short form (16 VGA images at B=16, one rep, 16
     1080p frames at B=4) against the C library on one core: bench.py's
     keys and `baseline`, a vs_baseline, 16 `dense0_filter` launches, the
     batch's boxes identical to the C library's, scores within 2e-4; (b)
     scripts/bench_1080p_torch.run over 4 frames at B=2: its keys, 20
     launches.

 25. (run after phase 3) the survivor tail kernel (`tail_walk`, csrc/tail.cu) at
     the benchmark cells' shapes: detect_stream of 16 VGA textures (bench
     model), CppDetector.detect_batch method 1 of 8 VGA scenes (flagship
     model, rounding) and detect of one 1080p frame: every field of
     run_fused bit-equal to the plain tail on the card, one launch a call;
     the kernel's time (profiler) beside its bound (the regressions' weight
     rows from L2), a call's wall time and kernels with the kernel and
     with the plain tail.  `python3 chip_smoke.py 25` runs phases 1 and 25
     alone.
 26. (run after phase 25, in a process of its own) the o/h/q pyramid
     kernel (`pyramid_levels`, csrc/pyramid.cu) on a VGA image and a 1080p
     frame: bit-equal to the host pyramid_c + stack_pyramid and to its
     plain twin on the card, one launch in Detector.detect of a multi-scale
     model; its time (profiler, all of 20 launches, and CUDA events over
     200 launches) beside its byte bound, the plain twin's time, the host
     pyramid's and the detector's whole step (pinned upload and launch).
     `python3 chip_smoke.py 26` runs phases 1 and 26 alone.  The kernel
     table's launches an image are phase 9's count.

The last lines are the card (nvidia-smi name and power limit), a
{"kernels": [...]} JSON line, and {"ok": true, "device": {...}}.  Without a
CUDA device it exits non-zero and prints no result.
"""

import copy
import dataclasses
import functools
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from bench_torch import KW as BENCH_KW, make_image

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores


# 27-landmark face template in [0, 1] window coordinates (brows, eyes,
# nose, mouth, chin): the layout the flagship model was trained on
FACE27 = np.array([
    [0.22, 0.30], [0.30, 0.26], [0.38, 0.30], [0.62, 0.30], [0.70, 0.26],
    [0.78, 0.26], [0.25, 0.40], [0.31, 0.38], [0.35, 0.41], [0.65, 0.41],
    [0.69, 0.38], [0.75, 0.40], [0.50, 0.45], [0.44, 0.55], [0.50, 0.58],
    [0.56, 0.55], [0.50, 0.62], [0.35, 0.72], [0.42, 0.69], [0.50, 0.68],
    [0.58, 0.69], [0.65, 0.72], [0.50, 0.74], [0.42, 0.76], [0.58, 0.76],
    [0.38, 0.88], [0.62, 0.88],
])


def _blur(img, sigma):
    """Separable Gaussian blur (reflected borders), float64."""
    r = int(3 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    out = np.pad(img, r, mode="reflect")
    out = np.apply_along_axis(np.convolve, 1, out, k, "valid")
    return np.apply_along_axis(np.convolve, 0, out, k, "valid")


def _face(rng, size, jitter=0.0):
    """A face patch as the flagship model's training scenes draw one: dark
    landmark blobs, a forehead band and cheek highlights on noise, band
    limited.  `jitter` > 0 moves each landmark by a normal draw of that
    deviation (in window units)."""
    base, spread = int(rng.integers(85, 175)), int(rng.integers(15, 45))
    img = rng.integers(base - spread, base + spread, (size, size)).astype(np.float64)
    dark, r = int(rng.integers(10, 60)), max(1, size // 24)
    lm = np.clip(FACE27 + rng.normal(0, jitter, FACE27.shape), 0.04, 0.96) if jitter else FACE27
    for gx, gy in lm:
        x, y = int(gx * size), int(gy * size)
        img[max(y - r, 0) : y + r + 1, max(x - r, 0) : x + r + 1] = dark
    ys = int(FACE27[:6, 1].min() * size)
    img[max(ys - size // 6, 0) : ys, size // 4 : 3 * size // 4] += int(rng.integers(25, 75))
    bh, cy, ch = max(3, size // 16), int(FACE27[13, 1] * size), int(rng.integers(15, 50))
    img[cy : cy + bh, size // 8 : size // 4] += ch
    img[cy : cy + bh, 3 * size // 4 : 7 * size // 8] += ch
    img += rng.integers(-12, 13, (size, size))
    img = _blur(np.clip(img, 0, 255), max(0.6, 0.6 * size / 48))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_scene(h, w, seed, faces=3):
    """`make_image` with `faces` non-overlapping faces of 60-149 px planted
    in it.  Returns (image, [(x, y, size)] of the faces)."""
    img = make_image(h, w, seed)
    rng = np.random.default_rng(seed + 1000)
    boxes = []
    for _ in range(faces):
        s = int(rng.integers(60, 150))
        for _ in range(50):
            x, y = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
            if all(x + s <= bx or bx + bs <= x or y + s <= by or by + bs <= y
                   for bx, by, bs in boxes):
                break
        img[y : y + s, x : x + s] = _face(rng, s)
        boxes.append((x, y, s))
    return img, boxes


def iou(a, b):
    """Intersection over union of two (x, y, w, h) boxes."""
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[0] + a[2], b[0] + b[2]), min(a[1] + a[3], b[1] + b[3])
    inter = max(0, x1 - x0) * max(0, y1 - y0)
    return inter / (a[2] * a[3] + b[2] * b[3] - inter)


def log(*a):
    print(*a, flush=True)


def dense0_launches(counters):
    """(dense0_filter, dense0_image) launches in a counter dict of
    jda_tpu_torch.tracing (drain or counting)."""
    return (counters.get("dense0_filter.launches", 0),
            counters.get("dense0_image.launches", 0))


def scale_tables(det, scales, device):
    """(tabi, tabf) per scan scale, as the detector's plan builds them."""
    import torch
    from jda_tpu_torch.ops import dense0 as D0

    out = []
    for win, step, _, _ in scales:
        t = D0.node_tables(det._ms32, det._host_stage0, win, step)
        tabi, tabf = D0.pack_tables(t, det.params.node_n)
        out.append((torch.as_tensor(tabi, device=device),
                    torch.as_tensor(tabf, device=device)))
    return out


def compare_filter(got, want, emit_lbf, what):
    """Kernel outputs against the plain version's (computed with leaf
    words): score, alive and nvis bit-equal, words equal where alive.
    Returns the largest |score| difference (0.0 when bit-equal)."""
    import torch

    torch.cuda.synchronize()
    for name, a, b in zip(("score", "alive", "nvis"), got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"dense0_filter != plain: {name}, {what}")
    if emit_lbf and not torch.equal(got[3][want[1]], want[3][want[1]]):
        raise AssertionError(f"dense0_filter != plain: lbf words of alive windows, {what}")
    return float((got[0] - want[0]).abs().max())


def check_kernel(img, tabs, scales, depth):
    """Per-scale entry against the plain version on every given scale, LBF
    off and on.  Returns (largest |score| difference, the plain outputs per
    scale)."""
    from jda_tpu_torch.ops import dense0 as D0

    err, wants = 0.0, []
    for (win, step, ny, nx), (tabi, tabf) in zip(scales, tabs):
        kw = dict(step=step, ny=ny, nx=nx, depth=depth)
        want = D0.scale_filter_reference(img, tabi, tabf, emit_lbf=True, **kw)
        wants.append(want)
        for emit_lbf in (False, True):
            got = D0.scale_filter(img, tabi, tabf, emit_lbf=emit_lbf, **kw)
            err = max(err, compare_filter(
                got, want, emit_lbf, f"win {win} lbf={emit_lbf} B={img.shape[0]}"))
        log(f"  win {win:4d} step {step:2d} grid {ny}x{nx} lbf=0/1: "
            f"bit-equal, alive {int(want[1].sum())} / {want[1].numel()}")
    return err, wants


def flat_ladder(wants):
    """Per-scale plain outputs -> the flat [B, n(, nw)] outputs of the ladder."""
    import torch

    B = wants[0][0].shape[0]
    return tuple(
        torch.cat([w[i].reshape((B, -1) + w[i].shape[3:]) for w in wants], dim=1)
        for i in range(4)
    )


def check_ladder(img, tabs, scales, depth, want, label):
    """Whole-ladder batch entry against the flat plain outputs, LBF off and
    on, two kernels per call.  Returns the largest |score| difference."""
    from jda_tpu_torch import tracing
    from jda_tpu_torch.ops import dense0 as D0

    err = 0.0
    for emit_lbf in (False, True):
        with tracing.counting() as n:
            got = D0.stage0_filter_all_scales(img, tabs, meta=scales, depth=depth,
                                              emit_lbf=emit_lbf)
        err = max(err, compare_filter(got, want, emit_lbf, f"{label} lbf={emit_lbf}"))
        if dense0_launches(n) != (2, 0):
            raise AssertionError(f"{label}: {dense0_launches(n)} launches")
    log(f"  {label}: {want[0].shape[1]} windows x {img.shape[0]} images over "
        f"{len(scales)} scales, lbf=0/1 bit-equal in 2 launches, "
        f"alive {int(want[1].sum())}")
    return err


def plain_flat(img, tabs, scales, depth):
    """The plain version's flat [B, n(, nw)] outputs of a whole ladder,
    with leaf words."""
    from jda_tpu_torch.ops import dense0 as D0

    return flat_ladder([
        D0.scale_filter_reference(img, tabi, tabf, step=step, ny=ny, nx=nx,
                                  depth=depth, emit_lbf=True)
        for (_, step, ny, nx), (tabi, tabf) in zip(scales, tabs)
    ])


def same_cpp(a, b, what):
    """Two CppDetector results (rects, scores, shapes, statistic) bit-equal."""
    for f, x, y in zip(("rects", "scores", "shapes"), a[:3], b[:3]):
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {f} differ ({len(a[0])} vs {len(b[0])} boxes)")
    if a[3] != b[3]:
        raise AssertionError(f"{what}: statistics differ, {a[3]} vs {b[3]}")


def same_result(a, b, what):
    for f in ("bboxes", "scores", "shapes"):
        if not np.array_equal(getattr(a, f), getattr(b, f)):
            raise AssertionError(f"{what}: {f} differ ({a.n} vs {b.n} boxes)")


def check_image_kernel(img, tabs, scales, depth, label):
    """`dense0_image` on one image against its plain version and against
    `dense0_filter` at B=1, scale by scale.  Returns (largest |score|
    difference, the kernel's outputs)."""
    import torch
    from jda_tpu_torch.ops import dense0 as D0

    got = D0.stage0_filter_image(img, tabs, meta=scales, depth=depth)
    want = D0.stage0_filter_image_reference(img, tabs, meta=scales, depth=depth)
    batch = D0.stage0_filter_all_scales(img[None], tabs, meta=scales, depth=depth)
    torch.cuda.synchronize()
    for name, a, b, c in zip(("score", "alive", "nvis"), got, want, batch):
        if not torch.equal(a, b):
            raise AssertionError(f"dense0_image != plain: {name}, {label}")
        if not torch.equal(a, c[0]):
            raise AssertionError(f"dense0_image != dense0_filter at B=1: {name}, {label}")
    log(f"  {label}: {got[0].numel()} windows over {len(scales)} scales bit-equal to "
        f"plain and to dense0_filter at B=1, alive {int(got[1].sum())}, "
        f"cart visits {int(got[2].sum(dtype=torch.int64))}")
    return float((got[0] - want[0]).abs().max()), got


def ladder_bound(B, H, W, n_scales, n, K, node_n, nvis_sum, depth, lbf_bytes=0):
    """Least time for one call of the ladder kernels on B images: (bytes ms,
    operations ms, bytes, operations)."""
    bytes_moved = (
        B * H * W  # the images, read once
        + n_scales * K * node_n * 16 + K * (node_n + 4) * 4 + n_scales * 16  # tables
        + B * n * (4 + 1 + 4)  # score, alive, nvis
        + lbf_bytes  # leaf words of the windows that stay alive
    )
    # per visited cart: (depth-1) node steps of subtract, compare and two
    # index ops; add, subtract, divide and compare in the score chain
    ops = nvis_sum * ((depth - 1) * 4 + 4)
    return (bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3,
            bytes_moved, ops)


def bound_of(bytes_ms, ops_ms):
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def cuda_ms(fn, reps, groups=5):
    """Median over `groups` of the CUDA-event time of `reps` calls, per call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def phase_ms(launcher, scratch, head_carts, reps=10):
    """Median CUDA-event time of the head and of the survivor launch of the
    kernel behind `launcher` (D0.launch or D0.launch_image with its images,
    tables and outputs bound), and the survivor queue's length."""
    import torch
    from jda_tpu_torch.ops import dense0 as D0

    heads, survs = [], []
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        launcher(head_carts=head_carts, phases=D0.PHASE_HEAD, scratch=scratch)
        ev[1].record()
        launcher(head_carts=head_carts, phases=D0.PHASE_SURVIVORS, scratch=scratch)
        ev[2].record()
        torch.cuda.synchronize()
        heads.append(ev[0].elapsed_time(ev[1]))
        survs.append(ev[1].elapsed_time(ev[2]))
    return statistics.median(heads), statistics.median(survs), int(scratch[1][0])


def head_sweep(tag, label, launcher, out, scratch):
    """Time the kernel behind `launcher` at head lengths 8, 16, 32 and 64.
    `out` holds the outputs at the head length in use, which an earlier
    phase held against the plain version on these inputs; every length must
    reproduce them: score, alive and nvis bit-equal, leaf words equal where
    alive."""
    import torch

    want = tuple(o.clone() for o in out)
    total = want[2].numel()
    for C in (8, 16, 32, 64):
        for o in out:
            o.fill_(-1)
        launcher(head_carts=C, scratch=scratch)
        torch.cuda.synchronize()
        for name, a, b in zip(("score", "alive", "nvis"), out, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{label}, head of {C} carts: {name} differs")
        if len(out) > 3 and not torch.equal(out[3][want[1]], want[3][want[1]]):
            raise AssertionError(f"{label}, head of {C} carts: leaf words differ")
        c_ms = cuda_ms(lambda: launcher(head_carts=C, scratch=scratch), reps=10, groups=3)
        h, sv, q = phase_ms(launcher, scratch, C, reps=5)
        reach = int((want[2] > C).sum())
        log(f"[{tag}] {label}, head of {C:2d} carts: bit-equal; {reach} of {total} windows "
            f"({reach / total:.5f}) visit cart {C}, queue {q}; {c_ms:.4f} ms, "
            f"head {h:.4f}, survivors {sv:.4f}")


def ladder_outputs(B, t, words=True):
    import torch
    from jda_tpu_torch.ops import dense0 as D0

    dev = t.nodes.device
    out = (torch.empty((B, t.n), dtype=torch.float32, device=dev),
           torch.empty((B, t.n), dtype=torch.bool, device=dev),
           torch.empty((B, t.n), dtype=torch.int32, device=dev))
    if words:
        out += (torch.empty((B, t.n, D0.lbf_words(t.tabf.shape[0])),
                            dtype=torch.int32, device=dev),)
    return out


def m0_canvas(cpp, gray, plan):
    """An image's method-0 pyramid packed as the bands of its canvas, as
    CppDetector._detect_m0_raw_batch lays it out."""
    canvas = np.zeros((plan["Hc"], plan["Wc"]), np.uint8)
    for (y0, _, _), (level, _) in zip(plan["m0_layout"], cpp._pyramid_m0(gray)):
        canvas[y0 : y0 + level.shape[0], : level.shape[1]] = level
    return canvas


def event_ms(fn):
    """CUDA-event time of one call of fn (for the plain versions, seconds
    per call) and its result."""
    import torch

    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def faces_found(results, truths):
    """(planted faces matched by a detection at IoU >= 0.5, planted faces)."""
    found = total = 0
    for (rects, _, _, _), boxes in zip(results, truths):
        for x, y, s in boxes:
            total += 1
            found += any(iou((x, y, s, s), r) >= 0.5 for r in rects)
    return found, total


def fold_lines(names, results):
    """A fold file's lines for these images and CppDetector results
    (test.cpp:153,163)."""
    lines = []
    for name, (rects, scores, _, _) in zip(names, results):
        lines += [name, str(len(rects))]
        lines += [f"{r[0]} {r[1]} {r[2]} {r[3]} {s:.6f}" for r, s in zip(rects, scores)]
    return lines


def cpp_phases(dev, depth, ms_model):
    """Phases 12-15: the C++-semantics path (CppDetector, run_fddb) on the
    card.  Returns the numbers the kernels line takes from them."""
    import torch
    import jda_tpu_torch as jt
    from jda_tpu_torch.cascador import CppDetector
    from jda_tpu_torch import tracing
    from jda_tpu_torch.fddb import run_fddb
    from jda_tpu_torch.ops import dense0 as D0

    root = os.path.dirname(os.path.abspath(__file__))
    flag = jt.load_model(os.path.join(root, "models", "flagship_synth.model"))
    K, node_n = flag.K, flag.node_n
    nw = D0.lbf_words(K)
    got = {}

    def counts(n):
        torch.cuda.synchronize()
        return dense0_launches(n)

    # -- 12. both kernels on the C++ path's tables ---------------------------------
    t0 = time.perf_counter()
    scenes = [make_scene(480, 640, seed=200 + i) for i in range(16)]
    imgs = [g for g, _ in scenes]
    truth = [b for _, b in scenes]
    cpp1 = CppDetector(flag, jt.Config(fddb_detect_method=1))
    cpp0 = CppDetector(flag, jt.Config(fddb_detect_method=0))
    plan1 = cpp1._m1_plan(480, 640)
    n1, s1 = plan1["n"], len(plan1["scales"])
    if plan1["scales"][0][:2] != (20, 5) or s1 != 13:
        raise AssertionError(f"method-1 ladder: {plan1['scales']}")
    b8 = torch.as_tensor(np.stack(imgs[:8]), device=dev)
    log(f"[12] method-1 ladder (rounding tables): {s1} scales from win 20 at step 5, "
        f"{n1} windows per image")
    plain1_ms, want = event_ms(lambda: plain_flat(b8, plan1["tabs"], plan1["scales"], depth))
    err = check_ladder(b8, plan1["tabs"], plan1["scales"], depth, want, "method-1 ladder B=8")
    prep1 = D0.prepare_image(plan1["tabs"], meta=plan1["scales"], depth=depth, H=480, W=640)
    out8, scr8 = ladder_outputs(8, prep1), D0.walk_scratch(8, prep1)
    m1_ms = cuda_ms(lambda: D0.launch(b8, prep1, out8, scratch=scr8), reps=20)
    head, surv, queue = phase_ms(lambda **kw: D0.launch(b8, prep1, out8, **kw), scr8,
                                 D0.HEAD_CARTS)
    compare_filter(out8, want, True, "method-1 ladder B=8, timed outputs")
    nvis, alive = int(out8[2].sum(dtype=torch.int64)), int(out8[1].sum())
    by, op, _, _ = ladder_bound(8, 480, 640, s1, n1, K, node_n, nvis, depth,
                                lbf_bytes=alive * nw * 4)
    got["m1_b8"] = dict(ms=m1_ms, plain_ms=plain1_ms, bound=bound_of(by, op), queue=queue)
    log(f"[12] dense0_filter, method-1 ladder B=8 ({8 * n1} windows, LBF on): {m1_ms:.4f} ms "
        f"(head {head:.4f}, survivors {surv:.4f}, queue {queue}), plain {plain1_ms:.1f} ms, "
        f"bound {bound_of(by, op)[0]:.5f} ms ({bound_of(by, op)[1]}); alive {alive}, "
        f"cart visits {nvis}")
    del want, out8, scr8

    plan0 = cpp0._m0_plan(480, 640)
    canvas = torch.as_tensor(m0_canvas(cpp0, imgs[0], plan0), device=dev)[None]
    n0, s0 = plan0["n"], len(plan0["scales"])
    log(f"[12] method-0 canvas (shifted rounding tables): {tuple(canvas.shape[1:])}, {s0} "
        f"bands, {n0} windows, band origins {[o[0] for o in plan0['origins']]}")
    plain0_ms, want = event_ms(lambda: plain_flat(canvas, plan0["tabs"], plan0["scales"], depth))
    err = max(err, check_ladder(canvas, plan0["tabs"], plan0["scales"], depth, want,
                                "method-0 VGA canvas B=1"))
    prep0 = D0.prepare_image(plan0["tabs"], meta=plan0["scales"], depth=depth,
                             H=plan0["Hc"], W=640)
    out1, scr1 = ladder_outputs(1, prep0), D0.walk_scratch(1, prep0)
    m0_ms = cuda_ms(lambda: D0.launch(canvas, prep0, out1, scratch=scr1), reps=20)
    compare_filter(out1, want, True, "method-0 VGA canvas, timed outputs")
    nvis, alive = int(out1[2].sum(dtype=torch.int64)), int(out1[1].sum())
    by, op, _, _ = ladder_bound(1, plan0["Hc"], 640, s0, n0, K, node_n, nvis, depth,
                                lbf_bytes=alive * nw * 4)
    got["m0_canvas"] = dict(ms=m0_ms, plain_ms=plain0_ms, bound=bound_of(by, op))
    log(f"[12] dense0_filter, method-0 VGA canvas: {m0_ms:.4f} ms, plain {plain0_ms:.1f} ms, "
        f"bound {bound_of(by, op)[0]:.5f} ms ({bound_of(by, op)[1]}); alive {alive}")
    del want, out1, scr1

    hd_img, _ = make_scene(1080, 1920, seed=300)
    plan_hd = cpp0._m0_plan(1080, 1920)
    hd_canvas = torch.as_tensor(m0_canvas(cpp0, hd_img, plan_hd), device=dev)[None]
    log(f"[12] method-0 1080p canvas: {tuple(hd_canvas.shape[1:])}, "
        f"{len(plan_hd['scales'])} bands, {plan_hd['n']} windows")
    want = plain_flat(hd_canvas, plan_hd["tabs"], plan_hd["scales"], depth)
    err = max(err, check_ladder(hd_canvas, plan_hd["tabs"], plan_hd["scales"], depth, want,
                                "method-0 1080p canvas B=1"))
    del want

    e, out_img = check_image_kernel(b8[0], plan1["tabs"], plan1["scales"], depth,
                                    "dense0_image, method-1 ladder")
    img_err = e
    outi, scri = ladder_outputs(1, prep1, words=False), D0.walk_scratch(1, prep1)
    outi = tuple(o[0] for o in outi)
    img_ms = cuda_ms(lambda: D0.launch_image(b8[0], prep1, outi, scratch=scri), reps=20)
    plain_img_ms, _ = event_ms(lambda: D0.stage0_filter_image_reference(
        b8[0], plan1["tabs"], meta=plan1["scales"], depth=depth))
    nvis = int(out_img[2].sum(dtype=torch.int64))
    by, op, _, _ = ladder_bound(1, 480, 640, s1, n1, K, node_n, nvis, depth)
    got["m1_image"] = dict(ms=img_ms, plain_ms=plain_img_ms, bound=bound_of(by, op))
    log(f"[12] dense0_image, method-1 ladder of one image: {img_ms:.4f} ms, plain "
        f"{plain_img_ms:.1f} ms, bound {bound_of(by, op)[0]:.5f} ms ({bound_of(by, op)[1]}); "
        f"done in {time.perf_counter() - t0:.1f} s, max |score err| {max(err, img_err)}")
    got["err"], got["img_err"] = err, img_err
    del b8, outi, scri

    # -- 13. CppDetector on the card against the CPU ------------------------------------
    t0 = time.perf_counter()
    cpp1.detect_batch(imgs[8:])  # warm: the plan's kernel tables, the allocator
    torch.cuda.synchronize()
    t = time.perf_counter()
    with tracing.counting() as n:
        res_b = cpp1.detect_batch(imgs[:8])
    launches_b = counts(n)
    dt_b = time.perf_counter() - t
    cpp1.detect(imgs[8])
    torch.cuda.synchronize()
    t = time.perf_counter()
    with tracing.counting() as n:
        res_1 = [cpp1.detect(g) for g in imgs[:2]]
    launches_1 = counts(n)
    dt_1 = time.perf_counter() - t
    cpp0.detect(imgs[8])
    torch.cuda.synchronize()
    t = time.perf_counter()
    with tracing.counting() as n:
        res_0 = [cpp0.detect(g) for g in imgs[:2]]
    launches_0 = counts(n)
    dt_0 = time.perf_counter() - t
    log(f"[13] detect_batch, method 1, B=8: {dt_b:.3f} s = {8 / dt_b:.2f} img/s; launches "
        f"(dense0_filter, dense0_image) {launches_b}; faces per image "
        f"{[len(r[0]) for r in res_b]}")
    log(f"[13] detect, method 1, 2 images: {dt_1:.3f} s = {2 / dt_1:.2f} img/s, launches "
        f"{launches_1}; method 0, 2 images: {dt_0:.3f} s = {2 / dt_0:.2f} img/s, "
        f"launches {launches_0}")
    if launches_b != (2, 0) or launches_1 != (0, 4) or launches_0 != (4, 0):
        raise AssertionError(f"C++ path launches: batch {launches_b}, method 1 "
                             f"{launches_1}, method 0 {launches_0}")
    for r in res_b + res_1 + res_0:
        if not (np.isfinite(r[1]).all() and np.isfinite(r[2]).all()) or r[2].shape != (
                len(r[0]), 2 * flag.landmark_n):
            raise AssertionError("C++ path: non-finite output or output of the wrong shape")
    for a, b in zip(res_b[:2], res_1):
        same_cpp(a, b, "method 1: detect_batch against detect")
    w1 = CppDetector(flag, jt.Config(fddb_detect_method=1), device="cpu").detect(imgs[0])
    same_cpp(w1, res_b[0], "method 1 on the card against the CPU")
    w0 = CppDetector(flag, jt.Config(fddb_detect_method=0), device="cpu").detect(imgs[0])
    same_cpp(w0, res_0[0], "method 0 on the card against the CPU")
    f1, n_f1 = faces_found(res_b, truth[:8])
    f0, n_f0 = faces_found(res_0, truth[:2])
    if f1 != n_f1 or f0 != n_f0:
        raise AssertionError(f"planted faces found: method 1 {f1}/{n_f1}, method 0 {f0}/{n_f0}")
    log(f"[13] bit-equal to the CPU port on image 0 (method 1: {len(w1[0])} faces, "
        f"{w1[3]}; method 0: {len(w0[0])} faces); planted faces found {f1}/{n_f1} "
        f"(method 1), {f0}/{n_f0} (method 0); done in {time.perf_counter() - t0:.1f} s")
    got.update(paths={"cpp_m1_batch": launches_b, "cpp_m1_detect": launches_1,
                      "cpp_m0_detect": launches_0},
               rates={"cpp_m1_batch_img_s": 8 / dt_b, "cpp_m1_img_s": 2 / dt_1,
                      "cpp_m0_img_s": 2 / dt_0})

    # -- 14. a multi-scale model through method 0's dense path ---------------------------
    t0 = time.perf_counter()
    cpp_ms = CppDetector(ms_model, jt.Config(fddb_detect_method=0))
    if not cpp_ms._m0_dense_ms_applicable():
        raise AssertionError("the multi-scale model did not take the dense method-0 path")
    cpp_ms.detect(imgs[9])
    torch.cuda.synchronize()
    t = time.perf_counter()
    with tracing.counting() as n:
        r_ms = cpp_ms.detect(imgs[0])
    launches_ms = counts(n)
    dt_ms = time.perf_counter() - t
    same_cpp(CppDetector(ms_model, jt.Config(fddb_detect_method=0), device="cpu").detect(
        imgs[0]), r_ms, "multi-scale method 0 on the card against the CPU")
    if launches_ms != (0, 0):
        raise AssertionError(f"multi-scale method 0 launched the kernels {launches_ms}")
    log(f"[14] multi-scale model, method 0 (plain dense filter, no kernel): {dt_ms:.3f} s "
        f"per image, {len(r_ms[0])} faces, {r_ms[3]}, bit-equal to the CPU port; done in "
        f"{time.perf_counter() - t0:.1f} s")
    got["rates"]["cpp_ms_m0_img_s"] = 1 / dt_ms

    # -- 15. the FDDB harness --------------------------------------------------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "FDDB-folds"))
        by_path, folds = {}, {}
        for f in (1, 2):
            folds[f] = [f"scenes/fold_{f:02d}/img_{i:03d}" for i in range(8)]
            with open(os.path.join(tmp, "FDDB-folds", f"FDDB-fold-{f:02d}.txt"), "w") as fh:
                fh.write("\n".join(folds[f]) + "\n")
            for i, name in enumerate(folds[f]):
                by_path[os.path.join(tmp, "images", name + ".jpg")] = imgs[8 * (f - 1) + i]
        for method, want, fold_launches in ((1, res_b, (4, 0)), (0, res_0, (32, 0))):
            out_dir = os.path.join(tmp, f"out{method}")
            torch.cuda.synchronize()
            with tracing.counting() as n:
                stats = run_fddb(flag, jt.Config(fddb_detect_method=method, fddb_dir=tmp),
                                 folds=[1, 2], out_dir=out_dir, imread=by_path.get)
            launches = counts(n)
            with open(os.path.join(out_dir, "fold-01-out.txt")) as fh:
                lines = fh.read().splitlines()
            head_lines = fold_lines(folds[1], want)
            if stats["images"] != 16 or lines[: len(head_lines)] != head_lines:
                raise AssertionError(f"run_fddb method {method}: fold 1 differs from phase 13")
            if launches != fold_launches:
                raise AssertionError(f"run_fddb method {method}: launches {launches}")
            log(f"[15] run_fddb method {method}: {stats['images']} images, "
                f"{stats['images_per_sec']:.2f} img/s (plans built in the run), windows "
                f"{stats['windows']}, faces {stats['face_windows']}, mean reject carts "
                f"{stats['average_cart_n']:.4f}, launches {launches}; fold 1 equal to "
                f"phase 13")
            got["paths"][f"fddb_m{method}"] = launches
            got["rates"][f"fddb_m{method}_img_s"] = stats["images_per_sec"]
    log(f"[15] done in {time.perf_counter() - t0:.1f} s")
    return got


# the flagship training geometry, field for field from
# scripts/train_flagship.py:453-484, with one cut: T = 1 of its 5 stages
FLAGSHIP_T1 = dict(
    T=1, K=540, landmark_n=27, tree_depth=4, shift_size=0.02, multi_scale=False,
    img_o_size=48, img_h_size=36, img_q_size=24, mining_th=(0.2,), feats=(2000,),
    radius=(0.3,), probs=(0.9,), recall=(0.99,), drops=(1,), nps=(1.0,),
    score_normalization_steps=(10,), restart_on=True, restart_th=(0.001,),
    restart_times=5, face_augment_on=False, left_pupils=(8,), right_pupils=(13,),
    snapshot_iter=10_000, seed=11,
)
FIRST_CART = 532  # the model starts at cursor (0, 531): carts 532..539 are trained
W_REL_TOL = 1e-3  # W on the card against the CPU, of max |W| (float32 Cholesky)


def train_corpus(n, c, seed):
    """n training faces drawn in bulk: jittered FACE27 landmarks as dark
    3x3 blobs and a forehead band on noise (tests/test_training.py's
    make_face at 27 landmarks).  Returns (corpus rows [n, D], gt shapes)."""
    from jda_tpu_torch.ops.resize import cv2_resize

    rng = np.random.default_rng(seed)
    S = c.img_o_size
    lm = FACE27[None] + rng.normal(0, 0.02, (n, 27, 2))
    img = rng.integers(85, 175, n)[:, None, None] + rng.integers(-20, 21, (n, S, S))
    ix = np.clip((lm[..., 0] * S).astype(int), 0, S - 1)
    iy = np.clip((lm[..., 1] * S).astype(int), 0, S - 1)
    dark = rng.integers(10, 60, n)[:, None]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            img[np.arange(n)[:, None], np.clip(iy + dy, 0, S - 1),
                np.clip(ix + dx, 0, S - 1)] = dark
    img[:, 2 : S // 5, S // 4 : 3 * S // 4] += rng.integers(25, 75, n)[:, None, None]
    faces = np.clip(img, 0, 255).astype(np.uint8)
    rows = np.concatenate(
        [cv2_resize(faces, s, s).reshape(n, -1) for s in (S, c.img_h_size, c.img_q_size)], 1
    )
    return rows, lm.reshape(n, -1)


def flagship_trainer(c, rows, gts, bgs, device):
    """A Trainer on the flagship geometry from `empty_model` with its
    cursor at (0, FIRST_CART - 1): train() trains the stage's last carts,
    mines, normalises at cart 540 and runs the global regression."""
    from jda_tpu_torch.train.boost import Trainer, empty_model

    model = empty_model(c)
    model.cart_idx = FIRST_CART - 1
    tr = Trainer(c, model=model, device=device)
    tr.set_synthetic_data(rows, gts, bgs)
    return tr


def device_busy(run):
    """(wall s, device busy s, device events) of run() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, n = 0.0, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy += ev.device_time_total
            n += 1
    return wall, busy / 1e6, n


def train_phases(dev, card):
    """Phases 16-18: the trainer at the flagship width on the card against
    the CPU, timed at the flagship's corpus size, and the trained model in
    the C++-semantics detector.  Returns the two kernels' launches in 18
    and the card runs of phases 16 and 17 (model, live masks, next draw)."""
    import torch
    import jda_tpu_torch as jt
    from jda_tpu_torch.cascador import CppDetector
    from jda_tpu_torch.data import DataSet
    from jda_tpu_torch import tracing

    c = jt.Config(**FLAGSHIP_T1)
    bgs = [make_image(480, 640, seed=500 + i) for i in range(12)]

    # -- 16. training on the card against the CPU -------------------------------------
    t0 = time.perf_counter()
    rows, gts = train_corpus(1024, c, seed=1)
    runs = {}
    for device in ("cuda", "cpu"):
        tr = flagship_trainer(c, rows, gts, bgs, device)
        t = time.perf_counter()
        tr.train()
        runs[device] = (tr, time.perf_counter() - t)
    (a, ta), (b, tb) = runs["cuda"], runs["cpu"]
    for f in ("scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores",
              "cart_th", "mean", "std", "mean_shape"):
        if not np.array_equal(getattr(a.model, f), getattr(b.model, f)):
            raise AssertionError(f"[16] training: model field {f} differs, card vs CPU")
    w_err = float(np.abs(a.model.W - b.model.W).max())
    w_max = float(np.abs(b.model.W).max())
    if not w_err <= W_REL_TOL * w_max:
        raise AssertionError(f"[16] training: W differs by {w_err} (max |W| {w_max})")
    for name, x, y in (("pos live", a.pos.live, b.pos.live), ("neg live", a.neg.live, b.neg.live),
                       ("pos weights", a.pos.weights, b.pos.weights),
                       ("neg weights", a.neg.weights, b.neg.weights),
                       ("mined rows", a.neg.imgs, b.neg.imgs)):
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"[16] training: {name} differ, card vs CPU")
    draw16 = a.rng.integers(1 << 62)
    if draw16 != b.rng.integers(1 << 62):
        raise AssertionError("[16] training: the random streams diverged")
    ref16 = dict(model=a.model, pos_live=a.pos.live, neg_live=a.neg.live, next_draw=draw16,
                 seconds=ta)
    st = a.stats["stages"][0]
    if not (np.isfinite(a.model.W).all() and w_max > 0 and st["mean_error"] < st["mean_error_before"]):
        raise AssertionError(f"[16] training: regression did not fit ({st})")
    log(f"[16] flagship geometry (K=540, 27 landmarks, F=2000, LBF 4320 x 54), carts "
        f"{FIRST_CART}..{c.K - 1}, 1024 faces: card {ta:.1f} s, CPU {tb:.1f} s; every model "
        f"field but W equal, W max |diff| {w_err:.3g} of max |W| {w_max:.4g} (tolerance "
        f"{W_REL_TOL} relative); live masks, weights, {len(a.neg.imgs)} mined rows and the "
        f"random stream equal; {len(a.stats['mining'])} mining events; mean error "
        f"{st['mean_error_before']:.4f} -> {st['mean_error']:.4f}; "
        f"done in {time.perf_counter() - t0:.1f} s")
    del runs, a, b

    # -- 17. training timed at the flagship's corpus size -------------------------------
    t0 = time.perf_counter()
    n_faces = 16384
    rows, gts = train_corpus(n_faces, c, seed=2)
    tr = flagship_trainer(c, rows, gts, bgs, dev)
    t = time.perf_counter()
    tr.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    carts = [x["seconds"] for x in tr.stats["carts"]]
    nodes = tr.stats["nodes"]
    m0 = tr.stats["mining"][0]
    st = tr.stats["stages"][0]
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_"), "trained.model")
    jt.save_model(tr.model, path, dtype="double")
    ref17 = dict(model=copy.deepcopy(tr.model), pos_live=tr.pos.live.copy(),
                 neg_live=tr.neg.live.copy(),
                 next_draw=copy.deepcopy(tr.rng).integers(1 << 62), carts=list(carts),
                 nodes=list(nodes))
    # one more cart step, profiled (the model is saved: cart 539 may change)
    DataSet.update_weights(tr.pos, tr.neg)

    def cart_step():
        tr.train_cart(0, c.K - 1)
        tr.update_scores(tr.pos, 0, c.K - 1)
        tr.update_scores(tr.neg, 0, c.K - 1)

    cart_step()
    wall, busy, kernels = device_busy(cart_step)
    log(f"[17] {card}: flagship geometry, {n_faces} faces, {len(carts)} carts trained "
        f"({len(nodes)} nodes with restarts) in {train_s:.1f} s: per cart median "
        f"{statistics.median(carts):.3f} s, max {max(carts):.3f} s; split search per node "
        f"median {1e3 * statistics.median(nodes):.2f} ms, max {1e3 * max(nodes):.2f} ms")
    log(f"[17] {card}: one cart step (split search + two score updates) under "
        f"torch.profiler: wall {wall * 1e3:.1f} ms, {kernels} device events, device busy "
        f"{busy * 1e3:.1f} ms, idle share {1 - busy / wall:.3f}")
    log(f"[17] {card}: first mining event: {m0['mined']} of {m0['want']} negatives, "
        f"{m0['screened']} windows screened in {m0['screen_s']:.3f} s = "
        f"{m0['screened'] / m0['screen_s']:.0f} windows/s, host rebuild and revalidation "
        f"{m0['revalidate_s']:.3f} s, {m0['seconds']:.3f} s in all; every event (mined, "
        f"windows screened, screen s, host s, s): "
        f"{[(m['mined'], m['screened'], round(m['screen_s'], 3), round(m['revalidate_s'], 3), round(m['seconds'], 3)) for m in tr.stats['mining']]}")
    log(f"[17] {card}: gen_lbf (pos and neg, 540 carts) {st['gen_lbf_s']:.3f} s, ridge "
        f"(LBF 4320 x 54, {tr.pos.size} positives) {st['ridge_s']:.3f} s, mean error "
        f"{st['mean_error_before']:.4f} -> {st['mean_error']:.4f}; "
        f"done in {time.perf_counter() - t0:.1f} s")
    del tr

    # -- 18. the trained model in the detector ------------------------------------------
    t0 = time.perf_counter()
    m = jt.load_model(path, dtype="double")
    imgs = [make_scene(480, 640, seed=600 + i)[0] for i in range(8)]
    cpp = CppDetector(m, jt.Config(fddb_detect_method=1))
    cpp.detect_batch(imgs)  # warm: the plan's kernel tables
    torch.cuda.synchronize()
    t = time.perf_counter()
    with tracing.counting() as n:
        res = cpp.detect_batch(imgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = dense0_launches(n)
    if launches != (2, 0):
        raise AssertionError(f"[18] trained model: launches {launches}, not (2, 0)")
    if n.get("plan.builds", 0):
        raise AssertionError("[18] trained model: the warm call's plan was built again")
    for r in res:
        if not (np.isfinite(r[1]).all() and np.isfinite(r[2]).all()) or r[2].shape != (
                len(r[0]), 2 * m.landmark_n):
            raise AssertionError("[18] trained model: non-finite output or wrong shape")
    t = time.perf_counter()
    want = CppDetector(m, jt.Config(fddb_detect_method=1), device="cpu").detect_batch(imgs)
    cpu_s = time.perf_counter() - t
    for i, (x, y) in enumerate(zip(res, want)):
        same_cpp(x, y, f"[18] trained model, image {i}: card against the CPU")
    log(f"[18] the trained model (saved as doubles, loaded) through CppDetector.detect_batch, "
        f"method 1, B=8: {dt:.3f} s = {8 / dt:.2f} img/s, launches (dense0_filter, "
        f"dense0_image) {launches}, boxes per image {[len(r[0]) for r in res]}; bit-equal "
        f"to the CPU port ({cpu_s:.1f} s); "
        f"done in {time.perf_counter() - t0:.1f} s")
    return launches, {16: ref16, 17: ref17}


HARD_FIRST_CART = 536  # phase 19 starts at cursor (0, 535): carts 536..539 are trained


def hard_canvas(rng, size, difficulty):
    """A face canvas for the canvas miner, modelled on make_hard_canvas
    (scripts/train_flagship.py:385-450) in numpy: a `_face` at (R, R) on a
    3R clutter canvas, blurred with `_blur` in place of band_limit.  Kind 0
    is a true face (only boundary-IoU windows are negatives), kind 1 moves
    the landmarks off the positives' band (less as the difficulty rises),
    kind 2 erases a band of the face.  Returns (canvas, (R, R, R),
    any_window)."""
    d = min(float(difficulty), 1.0)
    kind = int(rng.choice(3, p=[0.2, 0.5, 0.3]))
    R = int(rng.integers(size, 2 * size + 1))
    jitter = float(rng.uniform(0.05 - 0.024 * d, 0.09 - 0.05 * d)) if kind == 1 else 0.0
    face = _face(rng, R, jitter)
    if kind == 2:
        y0 = int(rng.uniform(0.15, 0.6) * R)
        face[y0 : y0 + int(rng.uniform(0.20 - 0.07 * d, 0.35 - 0.13 * d) * R)] = int(
            rng.integers(40, 215))
    canvas = rng.integers(40, 215, (3 * R, 3 * R)).astype(np.float64)
    canvas[R : 2 * R, R : 2 * R] = face
    canvas = _blur(canvas, max(0.6, 0.6 * R / 48))
    return np.clip(canvas, 0, 255).astype(np.uint8), (R, R, R), kind != 0


def near_miss(rng, size, difficulty):
    """A registered near-miss candidate for the hard factory, modelled on
    make_near_miss (scripts/train_flagship.py:278): one window of a
    `hard_canvas`, registered on an off-manifold face or shifted off a
    true face (IoU 0.28 at difficulty 0, 0.47 from difficulty 1 on),
    subsampled to size x size as the detection scan samples."""
    canvas, (fx, fy, fs), any_window = hard_canvas(rng, size, difficulty)
    x0, y0 = fx, fy
    if not any_window:
        a = int(round(fs * (0.36 + 0.2 * (1.0 - min(float(difficulty), 1.0)))))
        side = int(rng.integers(0, 4))
        x0 += (a, -a, 0, 0)[side]
        y0 += (0, 0, a, -a)[side]
    idx = (np.arange(size) * fs) // size
    return canvas[y0 + idx[:, None], x0 + idx[None, :]]


def hard_pool_trainer(c, rows, gts, bgs, device):
    """Phase 19's trainer: `empty_model` at cursor (0, HARD_FIRST_CART - 1),
    a starved scan (2 scan states of 64 windows, 2 batches: 256 windows
    while the first event wants one per face) and both factories
    registered, as scripts/train_flagship.py:598-611 registers them."""
    from jda_tpu_torch.train.boost import Trainer, empty_model

    model = empty_model(c)
    model.cart_idx = HARD_FIRST_CART - 1
    tr = Trainer(c, model=model, device=device)
    tr.mining_batch = 64
    tr.mining_max_batches = 2
    tr.neg_gen.n_states = 2
    tr.set_synthetic_data(rows, gts, bgs)
    o = c.img_o_size
    tr.neg_gen.load_hard_factory(
        lambda i, d=0.0: near_miss(np.random.default_rng(9_000_000 + i), o, d))
    tr.neg_gen.load_canvas_factory(
        lambda i, d=0.0: hard_canvas(np.random.default_rng(9_500_000 + i), o, d))
    # the mined (rows, scores, shapes) as each top-up and scan hands them
    # to the corpus: the global regression moves the stored shapes later by
    # W, which is equal only within W_REL_TOL
    mined = []
    append = tr.neg.append_negatives

    def record(rows, scores, shapes, mean_shape):
        mined.append((rows.copy(), scores.copy(), shapes.copy()))
        append(rows, scores, shapes, mean_shape)

    tr.neg.append_negatives = record
    return tr, mined


def hard_pool_phase(card):
    """Phase 19: the hard-pool miners at the flagship geometry on the card
    against the CPU, (a) with the canvas top-up, (b) with
    JDA_TPU_CANVAS_MINER=0 and the hard factory's."""
    import jda_tpu_torch as jt

    t0 = time.perf_counter()
    c = jt.Config(**FLAGSHIP_T1)
    rows, gts = train_corpus(1024, c, seed=1)  # phase 16's faces and backgrounds
    bgs = [make_image(480, 640, seed=500 + i) for i in range(12)]
    saved = os.environ.pop("JDA_TPU_CANVAS_MINER", None)
    try:
        for run, env in (("a", None), ("b", "0")):
            if env is not None:
                os.environ["JDA_TPU_CANVAS_MINER"] = env
            runs = {}
            for device in ("cuda", "cpu"):
                tr, mined = hard_pool_trainer(c, rows, gts, bgs, device)
                t = time.perf_counter()
                tr.train()
                runs[device] = (tr, time.perf_counter() - t, mined)
            (a, ta, mined_a), (b, tb, mined_b) = runs["cuda"], runs["cpu"]
            what = f"[19{run}] hard-pool mining"
            for f in ("scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores",
                      "cart_th", "mean", "std", "mean_shape"):
                if not np.array_equal(getattr(a.model, f), getattr(b.model, f)):
                    raise AssertionError(f"{what}: model field {f} differs, card vs CPU")
            w_err = float(np.abs(a.model.W - b.model.W).max())
            w_max = float(np.abs(b.model.W).max())
            if not w_err <= W_REL_TOL * w_max:
                raise AssertionError(f"{what}: W differs by {w_err} (max |W| {w_max})")
            if len(mined_a) != len(mined_b):
                raise AssertionError(f"{what}: {len(mined_a)} mined batches on the card, "
                                     f"{len(mined_b)} on the CPU")
            checks = [("pos live", a.pos.live, b.pos.live), ("neg live", a.neg.live, b.neg.live),
                      ("negative rows", a.neg.imgs, b.neg.imgs),
                      ("negative scores", a.neg.scores, b.neg.scores)]
            for i, (x, y) in enumerate(zip(mined_a, mined_b)):
                checks += [(f"mined rows {i}", x[0], y[0]), (f"mined scores {i}", x[1], y[1]),
                           (f"mined shapes {i}", x[2], y[2])]
            for name, x, y in checks:
                if x.shape != y.shape or not np.array_equal(x, y):
                    raise AssertionError(f"{what}: {name} differ, card vs CPU")
            # the stored shapes after the regression: each moved by a sum of
            # K rows of W, so they differ by at most K times W's difference
            s_err = float(np.abs(a.neg.current_shapes - b.neg.current_shapes).max())
            if not s_err <= 2 * c.K * w_err + 1e-12:
                raise AssertionError(f"{what}: negative shapes differ by {s_err} after the "
                                     f"regression (W by {w_err})")
            for attr in ("_hard_difficulty", "_hard_cursor", "_canvas_cursor"):
                if getattr(a.neg_gen, attr) != getattr(b.neg_gen, attr):
                    raise AssertionError(f"{what}: {attr} differs, card vs CPU")
            if a.rng.integers(1 << 62) != b.rng.integers(1 << 62):
                raise AssertionError(f"{what}: the random streams diverged")
            ev = a.stats["mining"]
            cuts = [e["max_batches"] != a.mining_max_batches for e in ev]
            if len(ev) < 2 or not any(cuts[1:]):
                raise AssertionError(f"{what}: {len(ev)} mining events, scan cut {cuts}")
            key = "canvas" if env is None else "hard"
            if not any(e[key] is not None and e[key]["mined"] > 0 for e in ev):
                raise AssertionError(f"{what}: no {key} top-up mined anything")
            if [e["max_batches"] for e in ev] != [e["max_batches"] for e in b.stats["mining"]]:
                raise AssertionError(f"{what}: the events differ, card vs CPU")
            log(f"{what}, {'canvas miner' if env is None else 'JDA_TPU_CANVAS_MINER=0'}: "
                f"carts {HARD_FIRST_CART}..{c.K - 1} at the flagship geometry, 1024 faces: "
                f"card {ta:.1f} s, CPU {tb:.1f} s; every model field but W equal, W max "
                f"|diff| {w_err:.3g} of max |W| {w_max:.4g}; live masks, {len(a.neg.imgs)} "
                f"negative rows and scores, the {sum(len(x[0]) for x in mined_a)} mined rows, "
                f"scores and shapes, difficulty {a.neg_gen._hard_difficulty:.2f}, "
                f"cursors ({a.neg_gen._hard_cursor}, {a.neg_gen._canvas_cursor}) and the "
                f"random stream equal; stored shapes after the regression within "
                f"{s_err:.3g}")
            for i, e in enumerate(ev):
                log(f"{what} event {i} (cart {e['cart']}): want {e['want']}, scan "
                    f"{e['scan_mined']} in max_batches {e['max_batches']} (cut "
                    f"{'taken' if cuts[i] else 'not taken'}), mined {e['mined']} in "
                    f"{e['seconds']:.3f} s")
                for k in ("canvas", "hard"):
                    h = e[k]
                    if h is None:
                        continue
                    if k == "canvas":
                        unit = "windows"
                        host = (f"screen loop {h['screen_s']:.3f} s = "
                                f"{h['screened'] / h['screen_s']:.0f} windows/s with the host "
                                f"render {h['render_s']:.3f} s in it, host rebuild and "
                                f"revalidation {h['revalidate_s']:.3f} s")
                    else:
                        unit = "candidates"
                        host = (f"host render {h['render_s']:.3f} s, validation "
                                f"{h['screen_s']:.3f} s")
                    log(f"{what} event {i} {k} top-up on {card}: {h['mined']} of {h['want']}, "
                        f"{h['screened']} {unit} screened in {h['seconds']:.3f} s = "
                        f"{h['screened'] / h['seconds']:.0f} {unit}/s; {host}; difficulty "
                        f"after {h['difficulty']:.2f}")
            del runs, a, b
    finally:
        os.environ.pop("JDA_TPU_CANVAS_MINER", None)
        if saved is not None:
            os.environ["JDA_TPU_CANVAS_MINER"] = saved
    log(f"[19] done in {time.perf_counter() - t0:.1f} s")


def same_state(got, want, what):
    """Every model field, W included, the live masks and the next draw."""
    for f in ("scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores",
              "cart_th", "mean", "std", "mean_shape", "W"):
        if not np.array_equal(getattr(got["model"], f), getattr(want["model"], f)):
            d = np.abs(getattr(got["model"], f) - getattr(want["model"], f)).max()
            raise AssertionError(f"{what}: model field {f} differs (max |diff| {d})")
    for k in ("pos_live", "neg_live", "next_draw"):
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"{what}: {k} differs")


def mesh_phase(card, model, vga, one, refs):
    """Phase 20: the multi-device paths on the card, each group a spawn of
    jda_tpu_torch.entry.run_on_mesh.  Returns dense0_filter's launches per
    rank in the detect_batch(mesh=) runs (one rank NCCL, two ranks gloo)."""
    import torch
    import jda_tpu_torch as jt
    from jda_tpu_torch.entry import dryrun_multichip, run_each, run_on_mesh
    from jda_tpu_torch.train.boost import empty_model
    from jda_tpu_torch.train.dryrun import detect_on_mesh, train_on_mesh

    c = jt.Config(**FLAGSHIP_T1)
    bgs = [make_image(480, 640, seed=500 + i) for i in range(12)]
    start = empty_model(c)
    start.cart_idx = FIRST_CART - 1
    train = functools.partial(train_on_mesh, model=start, mining_max_batches=2000,
                              mining_batch=2048)
    detect = functools.partial(detect_on_mesh, **BENCH_KW)

    # -- 20 (a) + (c): one rank over NCCL ----------------------------------------------
    t0 = time.perf_counter()
    rows, gts = train_corpus(16384, c, seed=2)
    (tr1, det1), = run_on_mesh(run_each, 1, [(train, (c, rows, gts, bgs)),
                                             (detect, (model, vga[:16]))], limit=900)
    same_state(tr1, refs[17], "[20a] one rank over NCCL against phase 17")
    carts = [x["seconds"] for x in tr1["stats"]["carts"]]
    nodes = tr1["stats"]["nodes"]
    col = tr1["collectives"]
    split = [col["classification"], col["regression"]]
    split_s = sum(x["seconds"] for x in split)
    split_n = sum(x["collectives"] for x in split)
    split_b = sum(x["bytes"] for x in split)
    log(f"[20a] {card}: Trainer(mesh=) at one rank over NCCL, flagship geometry, 16384 "
        f"faces, carts {FIRST_CART}..{c.K - 1}: every model field equal to phase 17's, W "
        f"included; live masks and the random stream equal; {tr1['seconds']:.1f} s; per "
        f"cart median {statistics.median(carts):.3f} s (phase 17 "
        f"{statistics.median(refs[17]['carts']):.3f} s), split search per node median "
        f"{1e3 * statistics.median(nodes):.2f} ms (phase 17 "
        f"{1e3 * statistics.median(refs[17]['nodes']):.2f} ms)")
    log(f"[20a] {card}: collectives of the split search (CUDA events around each "
        f"all-reduce): {split_n} all-reduces over {len(nodes)} nodes = "
        f"{split_n / len(nodes):.2f} per node, {split_b / len(nodes):.4g} bytes per node, "
        f"{1e3 * split_s / len(nodes):.3f} ms per node = {split_s / sum(nodes):.4f} of the "
        f"nodes' time; descend {col['descend']}, ridge {col['ridge']}; largest |exact sum| "
        f"{tr1['max_abs_sum']:.6g} residual units (exact below 2^14 = 16384)")
    if det1["launches"] != (2, 0):
        raise AssertionError(f"[20c] detect_batch(mesh=), one rank: launches {det1['launches']}")
    for i, (x, y) in enumerate(zip(det1["results"], one)):
        same_result(x, y, f"[20c] one rank over NCCL, image {i}: differs from phase 3")
    log(f"[20c] detect_batch(mesh=) at one rank over NCCL, VGA B=16: bit-equal to phase 3's "
        f"results, launches (dense0_filter, dense0_image) {det1['launches']}; (a) and (c) "
        f"done in {time.perf_counter() - t0:.1f} s")

    # -- 20 (b) + (c): two ranks on the one card over gloo ------------------------------
    t0 = time.perf_counter()
    rows, gts = train_corpus(1024, c, seed=1)  # phase 16's faces
    want17 = jt.Detector(model).detect_batch(vga[:17], **BENCH_KW)
    ranks = run_on_mesh(run_each, 2, [(train, (c, rows, gts, bgs)),
                                      (detect, (model, vga[:17]))],
                        backend="gloo", limit=900)
    for r, (tr2, det2) in enumerate(ranks):
        same_state(tr2, refs[16], f"[20b] rank {r} of 2 over gloo against phase 16's card run")
        if det2["launches"] != (2, 0):
            raise AssertionError(f"[20c] rank {r} of 2: launches {det2['launches']}")
        for i, (x, y) in enumerate(zip(det2["results"], want17)):
            same_result(x, y, f"[20c] rank {r} of 2 over gloo, image {i}: differs from no mesh")
        if len(det2["results"]) != 17:
            raise AssertionError(f"[20c] rank {r} of 2: {len(det2['results'])} results")
    col = ranks[0][0]["collectives"]
    log(f"[20b] Trainer(mesh=) at two ranks over gloo on one card, 1024 faces: both equal to "
        f"phase 16's card model in every field, W included, and to its live masks and random "
        f"stream; {ranks[0][0]['seconds']:.1f} / {ranks[1][0]['seconds']:.1f} s (phase 16's "
        f"card run alone {refs[16]['seconds']:.1f} s); collectives: classification {col['classification']}, "
        f"regression {col['regression']}, descend {col['descend']}, ridge {col['ridge']}")
    log(f"[20c] detect_batch(mesh=) at two ranks over gloo, 17 VGA images: each rank equal "
        f"to the batch without a mesh, launches per rank "
        f"{[d['launches'] for _, d in ranks]}; (b) and (c) done in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 20 (d): the dry runs ----------------------------------------------------------
    t0 = time.perf_counter()
    d1 = dryrun_multichip(1)
    d2 = dryrun_multichip(2, backend="gloo")
    log(f"[20d] dryrun_multichip(1) over NCCL and (2) over gloo on the card: windows "
        f"{d1[0]['windows']} / {d2[0]['windows']}, boxes {d1[0]['boxes']} / "
        f"{d2[0]['boxes']}; done in {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    return {"nccl_1": [det1["launches"][0]], "gloo_2": [d["launches"][0] for _, d in ranks]}


# -- phase 22: the flagship workflow -----------------------------------------

ROOT = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(ROOT, "models", "snapshots",
                        "jda_{}_20260819-142743_stage_5_cart_0.{}")
RESUME_CARTS = 3  # carts of stage 5 trained from the snapshot, card and CPU
RESUME_MINING_BATCHES = 2  # --mining-max-batches of that run
ALIGN_TOL = 1e-6  # mean alignment error against models/scene_eval.json

# SHA-256 of the generators' output (generator_digests), recorded from
# scripts/train_flagship.py with OpenCV 5.0.0's GaussianBlur and resize;
# tests/test_torch_flagship.py recomputes them from that script
GENERATOR_DIGESTS = {
    "make_face": "26c920a063f0eb0fa528e6f42da6a3a2857dfe2a39d82ba00be45ce313ef61ca",
    "make_bg": "f5fb891063461363a796b58e1f13772aeb63b3642bd23b9d664a7c8b6dc01707",
    "make_near_miss": "0723d5d7e37834eafebd3ca5b8c9cd03137d67b10c9c5021e5d55639a4a35328",
    "make_hard_canvas": "f5d6567ca11a7d6bcf36f62523abffa709732e40716c3dcb589ffd39fc2c358b",
    "build_scenes": "29e653d27bc4564b4f223f259e7fb56fa234cc0434f1b3904868ee3df1a23420",
}


def _sha256(parts):
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(f"{p.dtype}{p.shape}".encode())
            h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(repr(p).encode())
    return h.hexdigest()


def generator_digests(gen, scenes_gt):
    """SHA-256 of the flagship generators' output: 64 `make_face(rng, 48)`
    from seed 7, background tiles 0-7, `make_near_miss` at difficulties 0,
    0.5 and 1 in every mode, hard canvases 0-15 at difficulties 0 to 1.875,
    and `build_scenes(default_rng(123), 24)` (`scenes_gt`).  `gen` is a
    module of the generators: scripts/train_flagship_torch, or
    scripts/train_flagship with OpenCV."""
    rng = np.random.default_rng(7)
    faces = [a for _ in range(64) for a in gen.make_face(rng, 48)]
    bgs = [gen.make_bg(np.random.default_rng(7_000_000 + i)) for i in range(8)]
    near = [gen.make_near_miss(np.random.default_rng(9_000_000 + 5 * j + mode), 48, d, mode)
            for j, d in enumerate((0.0, 0.5, 1.0)) for mode in range(5)]
    canvases = [a for i in range(16)
                for a in gen.make_hard_canvas(np.random.default_rng(9_500_000 + i), 48, i / 8)]
    scenes, gt = scenes_gt
    return {
        "make_face": _sha256(faces),
        "make_bg": _sha256(bgs),
        "make_near_miss": _sha256(near),
        "make_hard_canvas": _sha256(canvases),
        "build_scenes": _sha256(list(scenes) + [a for boxes, lms in gt for a in [boxes, *lms]]),
    }


class _EnoughCarts(Exception):
    """Stops the resumed trainer after RESUME_CARTS carts."""


def resumed_stage5(device):
    """Stage 5 resumed from the snapshot pair through the script's resume
    path, stopped after RESUME_CARTS carts.  Returns (trainer, seconds,
    per-cart seconds, the mined (rows, scores, shapes) of each append)."""
    from scripts import train_flagship_torch as F

    args = F.parse_args(["--resume", SNAPSHOT.format("tmp", "model"),
                         "--resume-data", SNAPSHOT.format("data", "data"),
                         "--mining-max-batches", str(RESUME_MINING_BATCHES)])
    tr, _ = F.build_trainer(args, device)
    mined, carts = [], []
    append, train_cart = tr.neg.append_negatives, tr.train_cart

    def record(rows, scores, shapes, mean_shape):
        mined.append((rows.copy(), scores.copy(), shapes.copy()))
        append(rows, scores, shapes, mean_shape)

    def counted(t, k):
        if len(carts) == RESUME_CARTS:
            raise _EnoughCarts
        t0 = time.perf_counter()
        train_cart(t, k)
        carts.append(time.perf_counter() - t0)

    tr.neg.append_negatives, tr.train_cart = record, counted
    t0 = time.perf_counter()
    try:
        tr.train()
    except _EnoughCarts:
        pass
    return tr, time.perf_counter() - t0, carts, mined


def flagship_phase(card):
    """Phase 22: the flagship workflow on the card.  Returns dense0_filter's
    launches in the scene evaluation."""
    import jda_tpu_torch as jt
    from jda_tpu_torch import tracing
    from scripts import eval_synth_scenes_torch as E
    from scripts import train_flagship_torch as F

    t_phase = time.perf_counter()
    # (a) the generators without OpenCV
    t0 = time.perf_counter()
    scenes, gt = E.build_scenes(np.random.default_rng(123), E.N_SCENES)
    got = generator_digests(F, (scenes, gt))
    bad = [k for k in GENERATOR_DIGESTS if got.get(k) != GENERATOR_DIGESTS[k]]
    if bad or set(got) != set(GENERATOR_DIGESTS):
        raise AssertionError(f"[22a] generator digests differ: {bad}")
    log(f"[22a] {len(got)} generator digests equal to those recorded with OpenCV "
        f"({', '.join(got)}), {time.perf_counter() - t0:.1f} s")

    # (b) the scene evaluation of the shipped model
    with open(E.JAX_RECORD) as f:
        record = json.load(f)
    model = jt.load_model(os.path.join(ROOT, "models", "flagship_synth.model"))
    det = jt.Detector(model, rounding=True, device="cuda")
    kw = dict(batch=8, th=E.SWEEP[0], scale=record["ladder_scale"])
    t0 = time.perf_counter()
    det.detect_stream(scenes, **kw)  # builds the plan
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tracing.counting() as n:
        res = det.detect_stream(scenes, **kw)  # host results: the card is done
    secs = time.perf_counter() - t0
    launches = n.get("dense0_filter.launches", 0)
    batches = -(-len(scenes) // kw["batch"])
    if launches != 2 * batches:
        raise AssertionError(f"[22b] {launches} dense0_filter launches for {batches} batches")
    pts = E.sweep(res, gt)
    if [p["th"] for p in pts] != [p["th"] for p in record["sweep"]]:
        raise AssertionError("[22b] the sweep's thresholds differ from models/scene_eval.json")
    for p, q in zip(pts, record["sweep"]):
        for k in ("tp", "fp", "faces", "recall", "fp_per_scene"):
            if p[k] != q[k]:
                raise AssertionError(f"[22b] th {p['th']}: {k} {p[k]}, recorded {q[k]}")
        a, b = p["mean_align_error"], q["mean_align_error"]
        if (a is None) != (b is None) or (a is not None and not abs(a - b) <= ALIGN_TOL):
            raise AssertionError(f"[22b] th {p['th']}: alignment error {a}, recorded {b}")
    align = max(abs(p["mean_align_error"] - q["mean_align_error"])
                for p, q in zip(pts, record["sweep"]) if q["mean_align_error"] is not None)
    cpu = jt.Detector(model, rounding=True, device="cpu").detect_stream(scenes[:8], **kw)
    for i, (x, y) in enumerate(zip(res, cpu)):
        same_result(x, y, f"[22b] scene {i}, card against the CPU")
    top = pts[0]
    log(f"[22b] scene evaluation of models/flagship_synth.model, {len(scenes)} scenes at "
        f"B=8 on {card}: {len(scenes) / secs:.2f} img/s ({secs:.3f} s; first pass with the "
        f"plan {warm:.3f} s), dense0_filter launches {launches} ({launches // batches} per "
        f"batch); every sweep point equal to models/scene_eval.json (th {top['th']}: "
        f"{top['tp']}/{top['faces']} faces, {top['fp']} FP, alignment error "
        f"{top['mean_align_error']:.8f}, largest difference {align:.3g}); the first 8 scenes "
        f"bit-equal to the CPU")

    # (c) stage 5 resumed from the snapshot pair, card against the CPU
    t0 = time.perf_counter()
    snap = jt.load_model(SNAPSHOT.format("tmp", "model"))
    (a, ta, carts, mined_a), (b, tb, _, mined_b) = [resumed_stage5(d) for d in ("cuda", "cpu")]
    what = "[22c] stage 5 resumed"
    same_state(
        {"model": a.model, "pos_live": a.pos.live, "neg_live": a.neg.live,
         "next_draw": a.rng.integers(1 << 62)},
        {"model": b.model, "pos_live": b.pos.live, "neg_live": b.neg.live,
         "next_draw": b.rng.integers(1 << 62)}, what)
    if not np.array_equal(a.model.W, snap.W):
        raise AssertionError(f"{what}: W moved before the stage's end")
    if (a.model.stage_idx, a.model.cart_idx) != (snap.stage_idx, RESUME_CARTS - 1):
        raise AssertionError(f"{what}: cursor {(a.model.stage_idx, a.model.cart_idx)}")
    if len(mined_a) != len(mined_b) or not mined_a:
        raise AssertionError(f"{what}: {len(mined_a)} mined batches on the card, "
                             f"{len(mined_b)} on the CPU")
    checks = [("negative rows", a.neg.imgs, b.neg.imgs),
              ("negative scores", a.neg.scores, b.neg.scores),
              ("negative shapes", a.neg.current_shapes, b.neg.current_shapes),
              ("positive scores", a.pos.scores, b.pos.scores)]
    for i, (x, y) in enumerate(zip(mined_a, mined_b)):
        checks += [(f"mined rows {i}", x[0], y[0]), (f"mined scores {i}", x[1], y[1]),
                   (f"mined shapes {i}", x[2], y[2])]
    for name, x, y in checks:
        if x.shape != y.shape or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {name} differ, card vs CPU")
    for attr in ("_hard_difficulty", "_hard_cursor", "_canvas_cursor"):
        if getattr(a.neg_gen, attr) != getattr(b.neg_gen, attr):
            raise AssertionError(f"{what}: {attr} differs, card vs CPU")
    n_mined = sum(len(x[0]) for x in mined_a)
    log(f"{what} from the in-tree snapshot pair, carts 1..{RESUME_CARTS} of stage 5 "
        f"({a.pos.size} faces, {a.neg.size} negatives after), mining capped at "
        f"{RESUME_MINING_BATCHES} batches: card {ta:.1f} s, CPU {tb:.1f} s; every model field "
        f"equal (W untouched), live masks, {len(a.neg.imgs)} negative rows, scores and "
        f"shapes, the {n_mined} mined rows, scores and shapes, difficulty "
        f"{a.neg_gen._hard_difficulty:.2f}, cursors and the random stream equal")
    log(f"{what} on {card}: seconds per cart "
        f"{', '.join(f'{x:.3f}' for x in carts)} (mean {statistics.mean(carts):.3f})")
    for i, e in enumerate(a.stats["mining"]):
        ev = F._mining_summary(e)
        parts = "; ".join(
            f"{k} {p['mined']} of {p['screened']} screened in {p['seconds']:.3f} s = "
            f"{p['screened_per_s']:.0f}/s, host {p['host_s']:.3f} s"
            for k, p in ((k, ev[k]) for k in ("scan", "canvas", "hard")) if p is not None)
        log(f"{what} mining event {i} (cart {ev['cart']}) on {card}: want {ev['want']}, mined "
            f"{ev['mined']} in {ev['seconds']:.3f} s; {parts}")
    del a, b
    log(f"[22c] done in {time.perf_counter() - t0:.1f} s")
    log(f"[22] done in {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 23: the held-out and FDDB-format evaluations ------------------------

# fixed seeds of the perturbed families (scripts/eval_holdout_torch.py's
# main() keeps the JAX script's per-process hash(fam) seeding)
HOLDOUT_SEEDS = {"photometric": 101, "blur": 102, "occlusion": 103, "gradient": 104}
# SHA-256 of the six families' scenes and truths (holdout_digests), recorded
# from scripts/eval_holdout.py's functions with OpenCV 5.0.0 (IPP build);
# tests/test_torch_holdout.py recomputes them
HOLDOUT_DIGESTS = {
    "base": "9fb77bd966c92f1b1cff36c0f8becaef0196141937920fc5a4707221d2c5dfad",
    "photometric": "d1052faec7cf49c0cbd95367c193261f6c119e0331bc01d6ce3a281931567ffe",
    "blur": "b107f4122f5822066cb726c64977bd9ec9a4c709793c967891a1c62f34005fd4",
    "occlusion": "a05c2a14a68f5d20a464040678adba86a48bce8b3502a72b068b82ef89fbbf35",
    "gradient": "00251b4e6945e45f1f1f11f590e35ba345e85ade68a64201c3e41926b8766c19",
    "texture_bg": "d31bf7ac6469585906462365a5d8e874b752bf1e3c8da60ba89b4714a42f8ddf",
}
# SHA-256 of the 48 in-tree JPEGs of data/fddb_synth decoded by OpenCV
# (cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2GRAY)), per fold in list order
JPEG_DIGESTS = {
    "fold_01": "9abba7f51736b9aa447c84278aa397293af80323a72db8af8037a3686d73f7b2",
    "fold_02": "ca53d215df0afc6e72c37f94aaaf92ea55e9ad8a96f42ee186b476b3247727f0",
}
FDDB_SYNTH = os.path.join(ROOT, "data", "fddb_synth")


def holdout_digests(families):
    """SHA-256 of each family's scenes and truths."""
    return {fam: _sha256(list(scenes) + [a for boxes, lms in gt for a in [boxes, *lms]])
            for fam, (scenes, gt) in families.items()}


def fddb_jpeg_digests(read):
    """SHA-256 of each fold of data/fddb_synth decoded, `read(path)` in
    list order."""
    out = {}
    for f in (1, 2):
        with open(os.path.join(FDDB_SYNTH, "FDDB-folds", f"FDDB-fold-{f:02d}.txt")) as fh:
            names = fh.read().split()
        out[f"fold_{f:02d}"] = _sha256(
            [read(os.path.join(FDDB_SYNTH, "images", n + ".jpg")) for n in names])
    return out


def holdout_phase(card):
    """Phase 23: the held-out sweep and the FDDB-format run on the card.
    Returns dense0_filter's launches: (the six sweeps, run_fddb)."""
    import torch

    import jda_tpu_torch as jt
    from jda_tpu_torch import jpeg
    from jda_tpu_torch.fddb import run_fddb
    from jda_tpu_torch import tracing
    from scripts import eval_holdout_torch as EH
    from scripts import eval_synth_scenes_torch as E
    from scripts import synth_fddb_torch as SF
    from scripts.train_flagship_torch import flagship_config

    t_phase = time.perf_counter()
    # (a) the six families without OpenCV
    t0 = time.perf_counter()
    families = EH.build_families(24, HOLDOUT_SEEDS)
    t_build = time.perf_counter() - t0
    got = holdout_digests(families)
    bad = [k for k in EH.FAMILIES if got.get(k) != HOLDOUT_DIGESTS.get(k)]
    if bad:
        raise AssertionError(f"[23a] scene digests differ: {bad}")
    log(f"[23a] {len(got)} families of 24 scenes built in {t_build:.2f} s on the host; digests "
        f"equal to those recorded with OpenCV ({', '.join(EH.FAMILIES)})")

    # (b) the six sweeps of the shipped model
    with open(EH.JAX_RECORD) as f:
        record = json.load(f)
    model = jt.load_model(os.path.join(ROOT, "models", "flagship_synth.model"))
    det = jt.Detector(model, rounding=True, device="cuda")
    cpu = jt.Detector(model, rounding=True, device="cpu")
    kw = dict(batch=8, th=E.SWEEP[0], scale=record["ladder_scale"])
    t0 = time.perf_counter()
    det.detect_stream(families["base"][0][:8], **kw)  # builds the plan
    warm = time.perf_counter() - t0
    sweep_launches, secs, n_img = 0, 0.0, 0
    for fam, (scenes, gt) in families.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with tracing.counting() as n:
            res = det.detect_stream(scenes, **kw)  # host results: the card is done
        secs += time.perf_counter() - t0
        launches = n.get("dense0_filter.launches", 0)
        batches = -(-len(scenes) // kw["batch"])
        if launches != 2 * batches:
            raise AssertionError(f"[23b] {fam}: {launches} dense0_filter launches for "
                                 f"{batches} batches")
        sweep_launches += launches
        n_img += len(scenes)
        pts = E.sweep(res, gt)
        if fam in ("base", "texture_bg"):
            for p, q in zip(pts, record["families"][fam], strict=True):
                for k in ("th", "tp", "fp", "faces", "recall", "fp_per_scene"):
                    if p[k] != q[k]:
                        raise AssertionError(f"[23b] {fam} th {p['th']}: {k} {p[k]}, recorded {q[k]}")
                a, b = p["mean_align_error"], q["mean_align_error"]
                if (a is None) != (b is None) or (a is not None and not abs(a - b) <= ALIGN_TOL):
                    raise AssertionError(f"[23b] {fam} th {p['th']}: alignment error {a}, "
                                         f"recorded {b}")
        for i, (x, y) in enumerate(zip(res[:8], cpu.detect_stream(scenes[:8], **kw))):
            same_result(x, y, f"[23b] {fam} scene {i}, card against the CPU")
        top = pts[0]
        log(f"[23b] {fam}: th {top['th']} {top['tp']}/{top['faces']} faces, {top['fp']} FP, "
            f"alignment error {top['mean_align_error']}; th 0: {pts[5]['tp']} faces, "
            f"{pts[5]['fp']} FP; {launches} dense0_filter launches; the first 8 scenes "
            f"bit-equal to the CPU"
            + ("; every point equal to models/scene_eval_holdout.json"
               if fam in ("base", "texture_bg") else ""))
    log(f"[23b] six families, {n_img} scenes at B=8 on {card}: {n_img / secs:.2f} img/s "
        f"({secs:.3f} s; the plan built in {warm:.3f} s before)")

    # (c) the JPEG codec on the in-tree tree
    t0 = time.perf_counter()
    dec = fddb_jpeg_digests(jpeg.imread_gray)
    t_dec = (time.perf_counter() - t0) / 48
    if dec != JPEG_DIGESTS:
        raise AssertionError(f"[23c] decoded JPEG digests differ: "
                             f"{[k for k in JPEG_DIGESTS if dec.get(k) != JPEG_DIGESTS[k]]}")
    scenes, _ = E.build_scenes(np.random.default_rng(123), 4)
    t0 = time.perf_counter()
    encoded = [jpeg.encode_gray(s) for s in scenes]
    t_enc = (time.perf_counter() - t0) / len(scenes)
    for i, data in enumerate(encoded):
        with open(os.path.join(FDDB_SYNTH, "images", "synth", "fold_01", f"img_{i:03d}.jpg"),
                  "rb") as fh:
            if fh.read() != data:
                raise AssertionError(f"[23c] scene {i} encodes to other bytes than the in-tree file")
    log(f"[23c] the 48 in-tree JPEGs decoded equal to OpenCV's ({t_dec:.3f} s per image on the "
        f"host); fold 1's first 4 scenes encoded byte-equal to the in-tree files ({t_enc:.3f} s "
        f"per image)")

    # (d) run_fddb, method 1, over a copy of data/fddb_synth
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("FDDB-folds", "images"):
            shutil.copytree(os.path.join(FDDB_SYNTH, sub), os.path.join(tmp, sub))
        c = dataclasses.replace(
            flagship_config(),
            fddb_dir=tmp, fddb_detect_method=1, fddb_minimum_size=40,
            fddb_scale_factor=1.25, fddb_step=5, fddb_nms=True, fddb_result=False)
        out = os.path.join(tmp, "result_torch")
        torch.cuda.synchronize()
        with tracing.counting() as n:
            stats = run_fddb(model, c, folds=[1, 2], out_dir=out, imread=jpeg.imread_gray,
                             device="cuda")
        torch.cuda.synchronize()
        fddb_launches = dense0_launches(n)
        if fddb_launches != (12, 0):  # 3 batches of 8 per fold, 2 launches each
            raise AssertionError(f"[23d] run_fddb launches {fddb_launches}")
        report, bad = SF.compare_run(tmp, out, 2, FDDB_SYNTH)
        if bad:
            raise AssertionError(f"[23d] fold outputs differ from data/fddb_synth: {report}")
        cmp = report["fold_out"].values()
        n = sum(r["detections"] for r in cmp)
        digits = sum(r["printed_differently"] for r in cmp)
        worst = max(r["largest_difference"] for r in cmp)
        faces, roc = SF.score_outputs(tmp, 2, out)
        faces_j, roc_j = SF.score_outputs(FDDB_SYNTH, 2)
        pts, pts_j = SF.disc_roc_points(roc, 24), SF.disc_roc_points(roc_j, 24)
        if (faces, pts) != (faces_j, pts_j):
            raise AssertionError(f"[23d] discROC {faces} {pts}, the record's {faces_j} {pts_j}")
    log(f"[23d] run_fddb method 1 over data/fddb_synth (2 folds, {stats['images']} images, "
        f"read by jpeg.imread_gray) on {card}: {stats['images_per_sec']:.2f} img/s "
        f"({stats['seconds']:.3f} s of detection), windows {stats['windows']}, faces "
        f"{stats['face_windows']}, dense0_filter launches {fddb_launches[0]}; {n} detections: "
        f"rects equal to data/fddb_synth/result, scores within {SF.SCORE_TOL} (largest "
        f"difference {worst:.2g}, {digits} printed differently); discROC {pts} equal")
    log(f"[23] done in {time.perf_counter() - t_phase:.1f} s")
    return sweep_launches, fddb_launches[0]


# the keys of bench.py's JSON line (bench_torch.py adds "baseline" and
# "batch"), and of scripts/bench_1080p.py's less "tail" and "canvas"
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "windows_per_image", "windows_per_sec",
              "runs_images_per_sec", "ref_runs_images_per_sec", "p1080_stream_fps",
              "p1080_windows_per_frame", "p1080_windows_per_sec"}
BENCH_1080P_KEYS = {"metric", "sec_per_frame_b1", "lat_runs", "stream_fps", "batch", "frames",
                    "windows_per_frame", "windows_per_sec_stream"}


def bench_phase(card, model, vga):
    """Phase 24: the measurement entry points (bench_torch.py,
    scripts/bench_1080p_torch.py) in short form.  Returns dense0_filter's
    launches of each run, counts set to 0 just before it."""
    import torch

    import bench_torch as BT
    import jda_tpu_torch as jt
    from jda_tpu_torch import tracing
    from scripts import bench_1080p_torch as B1080

    t_phase = time.perf_counter()
    launches = {}
    # (a) bench_torch.run: one chunk of 16 VGA images, one rep, the 1080p
    # section at B=4 over 16 frames
    imgs = vga[:16]
    frames = [make_image(BT.HD_H, BT.HD_W, seed=BT.FRAME_SEED + i) for i in range(16)]
    det = jt.Detector(model)
    with tempfile.TemporaryDirectory() as tmp:
        base = BT.Baseline(model, tmp)
        with tracing.counting() as n:
            line, res = BT.run(det, imgs, frames, 16, 1, base, batch_1080=4)
        torch.cuda.synchronize()
        launches["bench_torch"] = n.get("dense0_filter.launches", 0)
        # warm 1 + timed 1 VGA batches (the warm pass takes two chunks of
        # what there is), warm 2 + timed 4 1080p batches, 2 each
        if launches["bench_torch"] != 2 * (1 + 1 + 2 + 4):
            raise AssertionError(f"[24a] bench_torch.run: {launches['bench_torch']} launches")
        if set(line) != BENCH_KEYS | {"baseline", "batch"} \
                or line["vs_baseline"] is None:
            raise AssertionError(f"[24a] bench_torch line: {line}")
        ds = 0.0
        for i, r in enumerate(res[:16]):
            nb, _, nsc = base.det.detect(imgs[i], **BENCH_KW)
            if not np.array_equal(nb, r.bboxes):
                raise AssertionError(f"[24a] image {i}: boxes differ from the C library")
            ds = max(ds, float(np.abs(nsc - r.scores).max()) if len(nb) else 0.0)
        if ds > 2e-4:
            raise AssertionError(f"[24a] scores differ from the C library by {ds}")
    log(f"[24a] bench_torch.run (BENCH_REPS=1, one chunk, 1080p on), baseline {line['baseline']} "
        f"on one core ({card}): {json.dumps(line)}; dense0_filter launches "
        f"{launches['bench_torch']}; the batch's {sum(r.n for r in res[:16])} boxes identical "
        f"to the C library, max |score| diff {ds:.3g}")

    # (b) scripts/bench_1080p_torch.run over 4 frames at B=2
    with tracing.counting() as n:
        line = B1080.run(model, frames[:4], 2, torch.device("cuda"))
    torch.cuda.synchronize()
    launches["bench_1080p"] = n.get("dense0_filter.launches", 0)
    # warm 1 + 5 latency calls, warm 2 + timed 2 stream batches, 2 each
    if launches["bench_1080p"] != 2 * (1 + 5 + 2 + 2) or set(line) != BENCH_1080P_KEYS:
        raise AssertionError(f"[24b] bench_1080p_torch: {launches['bench_1080p']} launches, "
                             f"line {line}")
    log(f"[24b] bench_1080p_torch.run (B1080_FRAMES=4): {json.dumps(line)}; dense0_filter "
        f"launches {launches['bench_1080p']}; phase 24 done in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


L2_BYTES_PER_S = 5.5e12  # H100 SXM L2 bandwidth: the survivor tail kernel's bound


def device_kernels(fn):
    """fn() under the device profiler: its result and the device's kernels
    as (name, seconds), copies and memsets left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    ops = [(ev.name, ev.device_time_total / 1e6) for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA
           and not ev.name.startswith(("Memcpy", "Memset"))]
    return out, ops


def wall_ms(fn, reps):
    """Median wall time of fn() in ms, the device synchronised around each."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def tail_regressions(counts, alive_final, T, split):
    """Lane-stages of one gather pass that end in an exact regression: every
    stage-0 survivor, then the lanes alive after each later stage (its
    stage-end compaction point; the final lanes still alive after the last)."""
    per = 2 if split else 1
    return counts[0] + sum(counts[per * t] for t in range(1, T - 1)) + alive_final


def tail_phase(card):
    """Phase 25: the survivor tail kernel (`tail_walk`, ops/tail.py) at the
    benchmark cells' shapes, against the plain tail on the card.  Returns
    the kernel table's row."""
    import unittest.mock as mock

    import torch

    import jda_tpu_torch as jt
    from jda_tpu_torch import tracing
    from jda_tpu_torch.cascador import CppDetector
    from jda_tpu_torch.ops import fused as F
    from jda_tpu_torch.ops import tail as TK

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    bench = jt.synthetic_model(T=5, K=540, landmark_n=27, seed=7,
                               drop_profile=jt.realistic_drop_profile(5, 540))
    flag = jt.load_model(os.path.join(root, "models", "flagship_synth.model"))
    cells = (
        ("vga_stream_b16", jt.Detector(bench),
         lambda d, g: d.detect_stream(g, batch=16, **BENCH_KW),
         [make_image(480, 640, seed=500 + i) for i in range(16)]),
        ("fddb_scenes_m1_b8", CppDetector(flag, jt.Config(fddb_detect_method=1)),
         lambda d, g: d.detect_batch(g),
         [make_scene(480, 640, seed=600 + i)[0] for i in range(8)]),
        ("hd_single_b1", jt.Detector(bench), lambda d, g: [d.detect(g[0], **BENCH_KW)],
         [make_image(1080, 1920, seed=700)]),
    )
    real_run, real_walk = F.run_fused, TK.walk
    row = {"name": "tail_walk", "route": "cuda", "source": "jda_tpu_torch/csrc/tail.cu",
           "replaces": None, "library_ms": None, "cells": {}}
    for name, det, call, imgs in cells:
        raws, walks = {True: [], False: []}, []

        def recorder(kernel):
            def run(*a, **kw):
                out = real_run(*a, **kw)
                raws[kernel].append({k: v.cpu() for k, v in out.items()})
                return out
            return run

        def walk(*a, **kw):
            walks.append((a, kw))
            return real_walk(*a, **kw)

        plain = mock.patch.object(F, "takes_tail_kernel", lambda *a: False)
        call(det, imgs)  # warm: plans, tables, the library
        with mock.patch.object(F, "run_fused", recorder(True)), \
                mock.patch.object(TK, "walk", walk):
            with tracing.counting() as c:
                got = call(det, imgs)
            torch.cuda.synchronize()
        with plain, mock.patch.object(F, "run_fused", recorder(False)):
            want = call(det, imgs)
        (rk,), (rp,) = raws[True], raws[False]
        for k in ("sel", "score", "shape", "alive", "nvis", "counts", "nvis_img", "total_nvis"):
            if not torch.equal(rk[k], rp[k]):
                raise AssertionError(f"[25] {name}: the kernel's {k} differs from the plain tail")
        for a, b in zip(want, got):
            if isinstance(a, tuple):
                same_cpp(a, b, f"[25] {name}")
            else:
                same_result(a, b, f"[25] {name}: results differ")
        if c.get("tail_kernel.launches") != 1 or len(walks) != 1:
            raise AssertionError(f"[25] {name}: {c.get('tail_kernel.launches')} tail launches")
        kernel_ms = wall_ms(lambda: call(det, imgs), 7)
        with plain:
            plain_ms = wall_ms(lambda: call(det, imgs), 3)
        _, ops_k = device_kernels(lambda: call(det, imgs))
        with plain:
            _, ops_p = device_kernels(lambda: call(det, imgs))
        # the recorded launch again, alone (it adds to a visit bank no one reads)
        a, kw = walks[0]
        _, ops_w = device_kernels(lambda: [real_walk(*a, **kw) for _ in range(10)])
        walk_ops = [d for n_, d in ops_k if "walk_kernel" in n_]
        replay = [d for n_, d in ops_w if "walk_kernel" in n_]
        tail_names = {n_ for n_, _ in ops_k + ops_w if "walk_kernel" in n_}
        if len(walk_ops) != 1 or len(replay) != 10 or any(
                k in n_ for n_ in tail_names for k in ("head_kernel", "survivor_kernel")):
            raise AssertionError(f"[25] {name}: tail kernels {tail_names}, in the call "
                                 f"{len(walk_ops)} of {len(ops_k)} device kernels, replays "
                                 f"{len(replay)} of {len(ops_w)}")
        tab = det.det._tail if hasattr(det, "det") else det._tail
        split = F.STAGE_SPLIT if tab.K > 2 * F.STAGE_SPLIT else 0
        counts = rk["counts"].tolist()
        regs = tail_regressions(counts, int(rk["alive"].sum()), tab.T, split)
        bound_ms = 1e3 * regs * tab.K * tab.L2 * 4 / L2_BYTES_PER_S
        cell = dict(
            kernel_ms=1e3 * statistics.median(replay), kernel_ms_in_call=1e3 * walk_ops[0],
            bound_ms=bound_ms, regressions=regs, lanes=counts[0], counts=counts,
            call_ms=kernel_ms, plain_call_ms=plain_ms, launches=len(ops_k),
            plain_launches=len(ops_p), images=len(imgs),
        )
        row["cells"][name] = cell
        log(f"[25] {name}: tail_walk {cell['kernel_ms']:.4f} ms (in the call "
            f"{cell['kernel_ms_in_call']:.4f}), bound {bound_ms:.4f} ms ({regs} lane-stage "
            f"regressions of {counts[0]} lanes, L2 bytes at {L2_BYTES_PER_S:.3g} B/s); a call "
            f"{kernel_ms:.2f} ms with the kernel, {plain_ms:.2f} ms with the plain tail; "
            f"kernels a call {len(ops_k)} against {len(ops_p)}; counts {counts}; every field "
            f"of run_fused bit-equal to the plain tail on the card ({card})")
    log(f"[25] done in {time.perf_counter() - t_phase:.1f} s")
    return row


def pyramid_phase(card):
    """Phase 26: the o/h/q pyramid kernel (`pyramid_levels`, ops/pyramid.py)
    on a VGA image and a 1080p frame, against the host pyramid it replaced
    and its plain twin on the card.  Returns the kernel table's row."""
    import torch

    import jda_tpu_torch as jt
    from jda_tpu_torch import tracing
    from jda_tpu_torch.ops import pyramid as PY
    from jda_tpu_torch.ops import resize as R

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # phase 9's model: its stage thresholds keep a few boxes, so NMS stays short
    det = jt.Detector(jt.synthetic_model(T=5, K=540, landmark_n=27, seed=7, multi_scale=True,
                                         drop_profile=jt.realistic_drop_profile(5, 540)))
    row = {"name": "pyramid_levels", "route": "cuda", "source": "jda_tpu_torch/csrc/pyramid.cu",
           "replaces": None, "library_ms": None, "sizes": {}}
    for label, (H, W) in (("vga", (480, 640)), ("1080p", (1080, 1920))):
        img = make_image(H, W, seed=800 + H)
        t0 = time.perf_counter()
        want, _, _ = R.stack_pyramid(R.pyramid_c(img))
        host_ms = 1e3 * (time.perf_counter() - t0)
        lay = PY.layout(H, W)
        flat = torch.empty(lay.F, dtype=torch.uint8, device=dev)
        flat[: H * W] = torch.from_numpy(img).reshape(-1).to(dev)
        with tracing.counting() as c:
            PY.fill_levels(flat, lay)
        plain = flat.clone()
        plain[H * W:] = 0
        PY.fill_levels_reference(plain, lay)
        torch.cuda.synchronize()
        if not np.array_equal(flat.cpu().numpy(), want) or not torch.equal(plain, flat):
            raise AssertionError(f"[26] {label}: the kernel's pyramid differs from pyramid_c")
        if c.get("pyramid_kernel.launches") != 1:
            raise AssertionError(f"[26] {label}: {c.get('pyramid_kernel.launches')} launches")
        # 20 launches under the profiler, every one of them recorded: the
        # profiler now and then drops a launch's record (the launch counter
        # says it ran), so a profile missing one is made again, twice at most
        for attempt in range(3):
            with tracing.counting() as c:
                _, ops = device_kernels(lambda: [PY.fill_levels(flat, lay) for _ in range(20)])
            if c.get("pyramid_kernel.launches") != 20:
                raise AssertionError(f"[26] {label}: {c} for 20 launches")
            kern = [d for n_, d in ops if "levels_kernel" in n_]
            if len(kern) == 20 and len(ops) == 20:
                break
            log(f"[26] {label}: the profiler recorded {len(kern)} pyramid kernels of "
                f"{len(ops)} device kernels for 20 launches: {ops[:2]}")
        else:
            raise AssertionError(f"[26] {label}: no profile of 20 launches recorded all 20")
        ms = cuda_ms(lambda: PY.fill_levels(flat, lay), 200)
        # the main path's launches: the detector's whole call on the image
        with tracing.counting() as c:
            det.detect(img, **BENCH_KW)
            torch.cuda.synchronize()
        launches = c.get("pyramid_kernel.launches", 0)
        if launches != 1:
            raise AssertionError(f"[26] {label}: detect launched the pyramid {launches} times")
        plain_ms = cuda_ms(lambda: PY.fill_levels_reference(plain, lay), 5)
        plan = det._plan(H, W, 1.25, 24, min(H, W))
        step_ms = wall_ms(lambda: det._pyramid(img, plan), 21)
        t_bytes = 1e3 * lay.F / HBM_BYTES_PER_S  # o read once, h and q written once
        cell = dict(kernel_ms=1e3 * statistics.median(kern), ms=ms, bound_ms=t_bytes,
                    bound_by="bytes", plain_ms=plain_ms, host_ms=host_ms, step_ms=step_ms,
                    F=lay.F, launches=launches)
        row["sizes"][label] = cell
        log(f"[26] {label} {H}x{W}: pyramid_levels {cell['kernel_ms'] * 1e3:.2f} us "
            f"(profiler, median of 20 launches; {ms * 1e3:.2f} us a launch back "
            f"to back), bound {t_bytes * 1e3:.3f} us "
            f"({lay.F} bytes at {HBM_BYTES_PER_S:.3g} B/s), plain twin on the "
            f"card {plain_ms:.3f} ms, host pyramid_c + stack {host_ms:.2f} ms; the detector's "
            f"step (pinned upload + launch, synchronised) {step_ms:.3f} ms; bit-equal to "
            f"pyramid_c and to the plain twin, {launches} launch in Detector.detect ({card})")
    row["launches_per_image"] = statistics.mean(c["launches"] for c in row["sizes"].values())
    log(f"[26] done in {time.perf_counter() - t_phase:.1f} s")
    return row


def pyramid_phase_apart(card):
    """Phase 26 in a process of its own (`chip_smoke.py 26`), where the
    profiler has recorded nothing before it.  Returns its kernel row."""
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "26"],
                         capture_output=True, text=True, timeout=600)
    rows = []
    for line in out.stdout.splitlines():
        if line.startswith("[26]"):
            log(line)
        elif line.startswith('{"kernels"'):
            rows = json.loads(line)["kernels"]
    if out.returncode != 0 or len(rows) != 1:
        raise AssertionError(f"[26] chip_smoke.py 26 failed, rc {out.returncode}:\n"
                             f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return rows[0]


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jda_tpu_torch as jt
    from jda_tpu_torch import native
    from jda_tpu_torch.detect import enumerate_windows
    from jda_tpu_torch.ops import _build
    from jda_tpu_torch import tracing
    from jda_tpu_torch.ops import dense0 as D0

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. build ---------------------------------------------------------------
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build_all(["dense0", "dense0_image", "tail", "pyramid"])
    log(f"[1] built dense0, dense0_image, tail and pyramid in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")
    if argv and list(argv) == ["25"]:  # the survivor tail kernel's phase alone
        row = tail_phase(card)
        log(card)
        log(json.dumps({"kernels": [row]}))
        log(json.dumps({"ok": True, "phases": [1, 25]}))
        return 0
    if argv and list(argv) == ["26"]:  # the pyramid kernel's phase alone
        row = pyramid_phase(card)
        log(card)
        log(json.dumps({"kernels": [row]}))
        log(json.dumps({"ok": True, "phases": [1, 26]}))
        return 0

    model = jt.synthetic_model(
        T=5, K=540, landmark_n=27, seed=7,
        drop_profile=jt.realistic_drop_profile(5, 540),
    )
    det = jt.Detector(model)
    depth = model.tree_depth

    # -- 2. kernel against its plain version ------------------------------------
    t0 = time.perf_counter()
    vga = [make_image(480, 640, seed=3 + i) for i in range(64)]
    _, _, _, vga_scales = enumerate_windows(640, 480, 1.25, 24, 480)
    vga_tabs = scale_tables(det, vga_scales, dev)
    vga_img = torch.as_tensor(np.stack(vga[:16]), device=dev)
    log(f"[2] dense0_filter vs plain, VGA B=16, {len(vga_scales)} scales")
    err, vga_wants = check_kernel(vga_img, vga_tabs, vga_scales, depth)
    hd = [make_image(1080, 1920, seed=31 + i) for i in range(8)]
    _, _, _, hd_scales = enumerate_windows(1920, 1080, 1.25, 24, 1080)
    pick = [i for i, s in enumerate(hd_scales) if s[0] in (24, 57, 88)]
    if len(pick) != 3:
        raise AssertionError(f"1080p ladder lacks win 24/57/88: {hd_scales}")
    hd_sel = [hd_scales[i] for i in pick]
    hd_img = torch.as_tensor(np.stack(hd[:4]), device=dev)
    hd_tabs = scale_tables(det, hd_scales, dev)
    log("[2] dense0_filter vs plain, 1080p B=4, win 24/57/88")
    e, hd_sel_wants = check_kernel(hd_img, [hd_tabs[i] for i in pick], hd_sel, depth)
    err = max(err, e)
    log(f"[2] done in {time.perf_counter() - t0:.1f} s, max |score err| {err}")

    # -- 11. the whole-ladder batch entry against the plain version ----------------
    t0 = time.perf_counter()
    log("[11] dense0_filter whole-ladder entry vs plain")

    def plain_ladder(img, tabs, scales, known=()):
        known = dict(known)
        return flat_ladder([
            known[i] if i in known else D0.scale_filter_reference(
                img, tabi, tabf, step=step, ny=ny, nx=nx, depth=depth, emit_lbf=True)
            for i, ((_, step, ny, nx), (tabi, tabf)) in enumerate(zip(scales, tabs))
        ])

    err = max(err, check_ladder(vga_img, vga_tabs, vga_scales, depth,
                                flat_ladder(vga_wants), "VGA B=16"))
    del vga_wants
    want = plain_ladder(hd_img, hd_tabs, hd_scales, zip(pick, hd_sel_wants))
    del hd_sel_wants
    err = max(err, check_ladder(hd_img, hd_tabs, hd_scales, depth, want, "1080p B=4"))
    # images of different sizes in one batch: each sits top-left in a zeroed
    # VGA plane, and the detector masks the windows outside an image's own size
    mixed = [vga[0]] + [np.ascontiguousarray(g[:h, :w]) for g, (h, w) in
                        zip(vga[1:4], ((400, 600), (300, 520), (480, 333)))]
    mix_img, _ = det._upload(mixed, len(mixed), 480, 640)
    want = plain_ladder(mix_img, vga_tabs, vga_scales)
    err = max(err, check_ladder(mix_img, vga_tabs, vga_scales, depth, want,
                                "mixed sizes B=4"))
    del want
    together = det.detect_batch(mixed, **BENCH_KW)
    for i, g in enumerate(mixed):
        same_result(det.detect_batch([g], **BENCH_KW)[0], together[i],
                    f"image {i} of the mixed batch differs from the image alone")
    log(f"[11] mixed batch through detect_batch: boxes {[r.n for r in together]}, each "
        f"equal to its image alone; done in {time.perf_counter() - t0:.1f} s, "
        f"max |score err| {err}")

    # -- 3. main path: detect_stream, VGA B=16 ----------------------------------
    n_vga = sum(ny * nx for _, _, ny, nx in vga_scales)
    t0 = time.perf_counter()
    det.detect_stream(vga, batch=16, **BENCH_KW)  # warm
    torch.cuda.synchronize()
    log(f"[3] warm pass {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tracing.counting() as n:
        res = det.detect_stream(vga, batch=16, **BENCH_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = n.get("dense0_filter.launches", 0)
    stats = det.last_stats
    log(f"[3] VGA detect_stream: {len(vga)} images in {dt:.3f} s = "
        f"{len(vga) / dt:.2f} img/s, {len(vga) * n_vga / dt:.4g} windows/s "
        f"({n_vga} windows/image)")
    log(f"[3] last batch counts {stats['counts']} total_nvis {stats['total_nvis']}, "
        f"dense0_filter launches {launches}")
    if launches != 4 * 2:  # head and survivor kernel, once per batch
        raise AssertionError(f"main path launched dense0_filter {launches} times")
    if n.get("plan.builds", 0):
        raise AssertionError("the warm pass's plan was built again")
    for r in res:
        if not (np.isfinite(r.scores).all() and np.isfinite(r.shapes).all()):
            raise AssertionError("non-finite detection output")
        if r.shapes.shape != (r.n, 2 * model.landmark_n) or r.bboxes.shape != (r.n, 3):
            raise AssertionError("detection output of the wrong shape")
    log(f"[3] boxes per image {[r.n for r in res[:16]]} ...")
    one = det.detect_batch(vga[:16], **BENCH_KW)
    for a, b in zip(one, res[:16]):
        if not (np.array_equal(a.bboxes, b.bboxes) and np.array_equal(a.scores, b.scores)
                and np.array_equal(a.shapes, b.shapes)):
            raise AssertionError("detect_stream differs from detect_batch")

    # -- 25. the survivor tail kernel against the plain tail ------------------------
    # (here, before the later phases: after phases 22-24 the profiler recorded no
    # device events in this process)
    tail_row = tail_phase(card)
    # -- 26. the o/h/q pyramid kernel against pyramid_c -----------------------------
    # (in a process of its own: late in a long process the profiler drops events)
    pyramid_row = pyramid_phase_apart(card)

    # -- 4. against the native C library ------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.model")
        jt.save_model(model, path, dtype="double")
        ndet = native.NativeDetector(path, dtype="double")
        cdet = jt.Detector(jt.load_model(path, dtype="double"))
        for i in range(2):
            nb, nsh, nsc = ndet.detect(vga[i], **BENCH_KW)
            r = cdet.detect(vga[i], **BENCH_KW)
            if not np.array_equal(nb, r.bboxes):
                raise AssertionError(f"image {i}: boxes differ from the C library "
                                     f"({len(nb)} vs {r.n})")
            ds = float(np.abs(nsc - r.scores).max()) if len(nb) else 0.0
            dsh = float(np.abs(nsh - r.shapes).max()) if len(nb) else 0.0
            if ds > 2e-4 or dsh > 2e-3:
                raise AssertionError(f"image {i}: score diff {ds}, shape diff {dsh}")
            log(f"[4] image {i}: {len(nb)} boxes identical to the C library, "
                f"max |score| diff {ds:.3g}, max |shape| diff {dsh:.3g}")
        ndet.close()

    # -- 5. 1080p stream -------------------------------------------------------------
    n_hd = sum(ny * nx for _, _, ny, nx in hd_scales)
    det.detect_stream(hd[4:], batch=4, **BENCH_KW)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with tracing.counting() as n:
        res_hd = det.detect_stream(hd[:4], batch=4, **BENCH_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hd_launches = n.get("dense0_filter.launches", 0)
    log(f"[5] 1080p detect_stream: 4 frames in {dt:.3f} s = {4 / dt:.3f} FPS, "
        f"{4 * n_hd / dt:.4g} windows/s, counts {det.last_stats['counts']}, "
        f"boxes {[r.n for r in res_hd]}, dense0_filter launches {hd_launches}")
    if hd_launches != 2:
        raise AssertionError(f"1080p path launched dense0_filter {hd_launches} times")

    # -- 6. dense0_filter per batch ------------------------------------------------------
    K = model.K
    node_n = model.node_n
    C0 = D0.HEAD_CARTS
    prep_vga = D0.prepare_image(vga_tabs, meta=vga_scales, depth=depth, H=480, W=640)
    prep_hd = D0.prepare_image(hd_tabs, meta=hd_scales, depth=depth, H=1080, W=1920)
    out16 = ladder_outputs(16, prep_vga)
    scr16 = D0.walk_scratch(16, prep_vga)
    # the same work as one per-scale call (a ladder of one scale) per scale
    singles = []
    for sc, tab in zip(vga_scales, vga_tabs):
        t1 = D0.prepare_image([tab], meta=[sc], depth=depth, H=480, W=640)
        singles.append((t1, ladder_outputs(16, t1), D0.walk_scratch(16, t1),
                        ladder_outputs(1, t1, words=False), D0.walk_scratch(1, t1)))

    def launch16(**kw):
        D0.launch(vga_img, prep_vga, out16, **kw)

    def ladder():
        launch16(scratch=scr16)

    def wrapper():
        D0.stage0_filter_all_scales(vga_img, vga_tabs, meta=vga_scales, depth=depth,
                                    emit_lbf=True, prepared=prep_vga)

    def per_scale():
        for t1, o16, s16, _, _ in singles:
            D0.launch(vga_img, t1, o16, scratch=s16)

    def plain():
        for (win, step, ny, nx), (tabi, tabf) in zip(vga_scales, vga_tabs):
            D0.scale_filter_reference(vga_img, tabi, tabf, step=step, ny=ny,
                                      nx=nx, depth=depth, emit_lbf=True)

    plain_ms = event_ms(plain)[0]  # one call: the plain version takes seconds
    ms = cuda_ms(ladder, reps=20)
    per_scale_ms = cuda_ms(per_scale, reps=5)
    wrapper_ms = cuda_ms(wrapper, reps=20)
    per_scale_ms2 = cuda_ms(per_scale, reps=5)
    ms2 = cuda_ms(ladder, reps=20)
    head_ms, surv_ms, queue_len = phase_ms(launch16, scr16, C0)
    alive_n = int(out16[1].sum())
    nvis_sum = int(out16[2].sum(dtype=torch.int64))
    t_bytes, t_ops, bytes_moved, ops = ladder_bound(
        16, 480, 640, len(vga_scales), n_vga, K, node_n, nvis_sum, depth,
        lbf_bytes=alive_n * D0.lbf_words(K) * 4)
    log(f"[6] dense0_filter per VGA batch (B=16, LBF on, 2 launches, head of {C0} carts): "
        f"{ms:.4f} / {ms2:.4f} ms kernels (head {head_ms:.4f}, survivors {surv_ms:.4f}), "
        f"{wrapper_ms:.4f} ms through the wrapper, {len(singles)} per-scale calls "
        f"{per_scale_ms:.4f} / {per_scale_ms2:.4f} ms, plain {plain_ms:.1f} ms; "
        f"bytes {bytes_moved} -> {t_bytes:.4f} ms, ops {ops} -> "
        f"{t_ops:.4f} ms; queue {queue_len} of {16 * n_vga} windows, alive {alive_n}, "
        f"cart visits {nvis_sum}, most by one window {int(out16[2].max())}")
    # where to cut the head: windows still alive after C carts, and the time
    # (with leaf words every window alive after the head queues)
    head_sweep(6, "VGA B=16, leaf words", launch16, out16, scr16)
    out4 = ladder_outputs(4, prep_hd)
    scr4 = D0.walk_scratch(4, prep_hd)

    def launch4(**kw):
        D0.launch(hd_img, prep_hd, out4, **kw)

    def plain4():
        for (win, step, ny, nx), (tabi, tabf) in zip(hd_scales, hd_tabs):
            D0.scale_filter_reference(hd_img, tabi, tabf, step=step, ny=ny,
                                      nx=nx, depth=depth, emit_lbf=True)

    hd4_ms = cuda_ms(lambda: launch4(scratch=scr4), reps=10)
    hd4_plain_ms = event_ms(plain4)[0]
    hd4_head, hd4_surv, hd4_queue = phase_ms(launch4, scr4, C0)
    hd4_alive = int(out4[1].sum())
    hd4_nvis = int(out4[2].sum(dtype=torch.int64))
    hb4_bytes, hb4_ops, _, _ = ladder_bound(
        4, 1080, 1920, len(hd_scales), n_hd, K, node_n, hd4_nvis, depth,
        lbf_bytes=hd4_alive * D0.lbf_words(K) * 4)
    log(f"[6] dense0_filter per 1080p batch (B=4, LBF on, 2 launches): {hd4_ms:.4f} ms "
        f"(head {hd4_head:.4f}, survivors {hd4_surv:.4f}), plain {hd4_plain_ms:.1f} ms, bound "
        f"{bound_of(hb4_bytes, hb4_ops)[0]:.5f} ms ({bound_of(hb4_bytes, hb4_ops)[1]}); "
        f"queue {hd4_queue} of {4 * n_hd} windows, alive {hd4_alive}, cart visits {hd4_nvis}")
    head_sweep(6, "1080p B=4, leaf words", launch4, out4, scr4)
    del out16, scr16, out4, scr4

    # -- 7. dense0_image against its plain version, full ladders --------------------
    t0 = time.perf_counter()
    log("[7] dense0_image vs plain and vs dense0_filter at B=1, full ladders")
    img_err = 0.0
    for i in range(4):
        e, out_vga = check_image_kernel(vga_img[i], vga_tabs, vga_scales, depth, f"VGA image {i}")
        img_err = max(img_err, e)
    if out_vga[0].numel() != n_vga:
        raise AssertionError(f"dense0_image: {out_vga[0].numel()} windows, not {n_vga}")
    e, out_hd = check_image_kernel(hd_img[0], hd_tabs, hd_scales, depth, "1080p frame 0")
    img_err = max(img_err, e)
    if out_hd[0].numel() != n_hd:
        raise AssertionError(f"dense0_image: {out_hd[0].numel()} windows, not {n_hd}")
    log(f"[7] done in {time.perf_counter() - t0:.1f} s, max |score err| {img_err}")

    # -- 8. the non-fused path: Detector.detect under JDA_TPU_FUSED=0 ----------------
    unfused_imgs = vga[:4] + hd[:1]
    fused_res = list(res[:4]) + list(res_hd[:1])
    saved_env = os.environ.get("JDA_TPU_FUSED")
    os.environ["JDA_TPU_FUSED"] = "0"
    try:
        for g in (vga[4], hd[1]):  # warm: plans, tables
            det.detect(g, **BENCH_KW)
        torch.cuda.synchronize()
        with tracing.counting() as n:
            t0 = time.perf_counter()
            unfused_res = [det.detect(g, **BENCH_KW) for g in unfused_imgs[:4]]
            torch.cuda.synchronize()
            dt_vga = time.perf_counter() - t0
            t0 = time.perf_counter()
            unfused_res.append(det.detect(unfused_imgs[4], **BENCH_KW))
            torch.cuda.synchronize()
            dt_hd = time.perf_counter() - t0
        stray, image_launches = dense0_launches(n)
    finally:
        if saved_env is None:
            os.environ.pop("JDA_TPU_FUSED", None)
        else:
            os.environ["JDA_TPU_FUSED"] = saved_env
    for i, (a, b) in enumerate(zip(fused_res, unfused_res)):
        same_result(a, b, f"non-fused detect differs from the fused path, image {i}")
        if not (np.isfinite(b.scores).all() and np.isfinite(b.shapes).all()):
            raise AssertionError("non-finite detection output")
    log(f"[8] non-fused detect: 4 VGA images in {dt_vga:.3f} s = {4 / dt_vga:.2f} img/s, "
        f"1 1080p frame in {dt_hd:.3f} s = {1 / dt_hd:.2f} FPS; boxes "
        f"{[r.n for r in unfused_res]} bit-equal to the fused path; dense0_image "
        f"launches {image_launches} for {len(unfused_imgs)} images (head and survivor "
        f"kernel per image), dense0_filter {stray}")
    if image_launches != 2 * len(unfused_imgs) or stray != 0:
        raise AssertionError(
            f"non-fused path launched dense0_image {image_launches} times and "
            f"dense0_filter {stray} times for {len(unfused_imgs)} images"
        )

    # -- 9. a multi-scale model: pyramid, the tail kernel's level walk -------------
    ms_model = jt.synthetic_model(
        T=5, K=540, landmark_n=27, seed=7, multi_scale=True,
        drop_profile=jt.realistic_drop_profile(5, 540),
    )
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ms.model")
        jt.save_model(ms_model, path, dtype="double")
        ms_loaded = jt.load_model(path, dtype="double")
        ms_det = jt.Detector(ms_loaded)
        ms_cpu = jt.Detector(ms_loaded, device="cpu")
        if ms_det.single_scale or ms_det._fused_enabled():
            raise AssertionError("the multi-scale model took the fused path")
        ndet = native.NativeDetector(path, dtype="double")
        # the C library's half and quarter patches read past their buffers
        # near the bottom edge; with the window pinned to 24 px every read
        # of a window at y <= H - 82 stays inside, and 24 px more keep NMS
        # from coupling those boxes with the rest
        pinned = dict(scale=1.25, min_size=24, max_size=24, th=-5.0)
        safe_y = 480 - 82 - 24
        n_safe = 0
        ms_pyramid_launches = []
        for i in range(2):
            t0 = time.perf_counter()
            with tracing.counting() as c:
                r = ms_det.detect(vga[i], **BENCH_KW)
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if (c.get("tail_kernel.launches") != 1 or c.get("pyramid_kernel.launches") != 1
                    or "run_batch.calls" in c):
                raise AssertionError(f"multi-scale detect: {c} (one pyramid and one tail "
                                     "kernel launch an image expected, no _run_batch)")
            ms_pyramid_launches.append(c["pyramid_kernel.launches"])
            same_result(ms_cpu.detect(vga[i], **BENCH_KW), r,
                        f"multi-scale detect on the card differs from the CPU, image {i}")
            rp = ms_det.detect(vga[i], **pinned)
            nb, nsh, nsc = ndet.detect(vga[i], **pinned)
            tm, om = rp.bboxes[:, 1] <= safe_y, nb[:, 1] <= safe_y
            if not np.array_equal(nb[om], rp.bboxes[tm]):
                raise AssertionError(f"multi-scale image {i}: boxes differ from the C "
                                     f"library ({om.sum()} vs {tm.sum()})")
            ds = float(np.abs(nsc[om] - rp.scores[tm]).max()) if om.any() else 0.0
            dsh = float(np.abs(nsh[om] - rp.shapes[tm]).max()) if om.any() else 0.0
            if ds > 2e-4 or dsh > 2e-3:
                raise AssertionError(f"multi-scale image {i}: score diff {ds}, shape diff {dsh}")
            n_safe += int(om.sum())
            log(f"[9] multi-scale image {i}: full ladder {r.n} boxes in {dt:.3f} s, bit-equal "
                f"to the CPU port; win 24: {int(om.sum())} of {len(nb)} boxes comparable, "
                f"identical to the C library, max |score| diff {ds:.3g}, "
                f"max |shape| diff {dsh:.3g}")
        ndet.close()
        if n_safe == 0:
            raise AssertionError("multi-scale: no box to compare with the C library")
    # the kernel table's launches of the pyramid kernel: the main path's, counted here
    pyramid_row["launches_per_image"] = statistics.mean(ms_pyramid_launches)

    # -- 10. dense0_image per image ---------------------------------------------------
    img0, hd0 = vga_img[0], hd_img[0]
    scr_vga = D0.walk_scratch(1, prep_vga)
    scr_hd = D0.walk_scratch(1, prep_hd)

    def launch_vga(**kw):
        D0.launch_image(img0, prep_vga, out_vga, **kw)

    def launch_hd(**kw):
        D0.launch_image(hd0, prep_hd, out_hd, **kw)

    def image_kernel():
        launch_vga(scratch=scr_vga)

    def image_wrapper():
        D0.stage0_filter_image(img0, vga_tabs, meta=vga_scales, depth=depth,
                               prepared=prep_vga)

    def image_plain():
        D0.stage0_filter_image_reference(img0, vga_tabs, meta=vga_scales, depth=depth)

    def per_scale_b1():  # the same work as one per-scale dense0_filter call per scale
        for t1, _, _, o1, s1 in singles:
            D0.launch(img0[None], t1, o1, scratch=s1)

    img_plain_ms = event_ms(image_plain)[0]
    img_ms = cuda_ms(image_kernel, reps=20)
    b1_ms = cuda_ms(per_scale_b1, reps=5)
    img_wrapper_ms = cuda_ms(image_wrapper, reps=20)
    b1_ms2 = cuda_ms(per_scale_b1, reps=5)
    img_ms2 = cuda_ms(image_kernel, reps=20)
    img_head, img_surv, img_queue = phase_ms(launch_vga, scr_vga, C0)
    hd_ms = cuda_ms(lambda: launch_hd(scratch=scr_hd), reps=10)
    hd_head, hd_surv, hd_queue = phase_ms(launch_hd, scr_hd, C0)
    nvis_vga = int(out_vga[2].sum(dtype=torch.int64))
    nvis_hd = int(out_hd[2].sum(dtype=torch.int64))
    ib_bytes, ib_ops, ib_nbytes, ib_nops = ladder_bound(
        1, 480, 640, len(vga_scales), n_vga, K, node_n, nvis_vga, depth)
    hb_bytes, hb_ops, _, _ = ladder_bound(
        1, 1080, 1920, len(hd_scales), n_hd, K, node_n, nvis_hd, depth)
    log(f"[10] dense0_image per VGA image (2 launches): {img_ms:.4f} / {img_ms2:.4f} ms "
        f"kernels (head {img_head:.4f}, survivors {img_surv:.4f}, queue {img_queue}), "
        f"{img_wrapper_ms:.4f} ms through the wrapper, plain {img_plain_ms:.1f} ms, "
        f"{len(singles)} per-scale dense0_filter calls at B=1 "
        f"{b1_ms:.4f} / {b1_ms2:.4f} ms; bytes {ib_nbytes} -> {ib_bytes:.5f} ms, ops "
        f"{ib_nops} -> {ib_ops:.5f} ms; cart visits {nvis_vga}, most by one window "
        f"{int(out_vga[2].max())}")
    log(f"[10] dense0_image per 1080p frame (2 launches): {hd_ms:.4f} ms (head "
        f"{hd_head:.4f}, survivors {hd_surv:.4f}, queue {hd_queue}), bound "
        f"{bound_of(hb_bytes, hb_ops)[0]:.5f} ms ({bound_of(hb_bytes, hb_ops)[1]}), "
        f"cart visits {nvis_hd}")
    head_sweep(10, "VGA image", launch_vga, out_vga, scr_vga)
    head_sweep(10, "1080p frame", launch_hd, out_hd, scr_hd)
    del out_vga, scr_vga, out_hd, scr_hd

    cpp = cpp_phases(dev, depth, ms_loaded)
    trained_launches, train_refs = train_phases(dev, card)
    hard_pool_phase(card)
    mesh_launches = mesh_phase(card, model, vga, one, train_refs)
    flagship_launches = flagship_phase(card)
    holdout_launches, fddb_synth_launches = holdout_phase(card)
    bench_launches = bench_phase(card, model, vga)
    log("the times of both kernels' first versions are in PERF.md's kernel table")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "dense0_filter",
        "route": "cuda",
        "source": "jda_tpu_torch/csrc/dense0.cu",
        "header": "jda_tpu_torch/csrc/dense0_walk.cuh",
        "replaces": "jda_tpu/ops/dense0.py:833",
        "also_replaces": ["jda_tpu/ops/dense0.py:1063", "jda_tpu/ops/dense0.py:1253"],
        "launches": launches,
        "launches_per_batch": launches // 4,  # the timed stream is 4 batches
        # each C++ path's own run, counts set to 0 just before it
        "launches_cpp": {k: v[0] for k, v in cpp["paths"].items()},
        "launches_trained_model": trained_launches[0],
        # detect_batch(mesh=) per rank (phase 20), counts set to 0 just before
        "launches_mesh": mesh_launches,
        # the scene evaluation of the flagship model (phase 22), 3 batches of
        # 8, counts set to 0 just before
        "launches_flagship_scenes": flagship_launches,
        # the held-out sweeps (phase 23b: 6 families, 3 batches of 8 each) and
        # run_fddb over data/fddb_synth (23d: 2 folds, 3 batches each), counts
        # set to 0 just before each
        "launches_holdout_sweeps": holdout_launches,
        "launches_fddb_synth": fddb_synth_launches,
        # the measurement entry points (phase 24: bench_torch.run,
        # bench_1080p_torch.run), counts set to 0 just before each
        "launches_bench": bench_launches,
        "max_abs_err": max(err, cpp["err"]),
        "ms": statistics.median([ms, ms2]),
        "head_ms": head_ms,
        "survivors_ms": surv_ms,
        "head_carts": C0,
        "queue_len": queue_len,
        "wrapper_ms": wrapper_ms,
        "per_scale_calls_ms": statistics.median([per_scale_ms, per_scale_ms2]),
        "plain_ms": plain_ms,
        "bound_ms": bound_of(t_bytes, t_ops)[0],
        "bound_by": bound_of(t_bytes, t_ops)[1],
        "library_ms": None,
        "ms_1080p": hd4_ms,
        "plain_ms_1080p": hd4_plain_ms,
        "bound_ms_1080p": bound_of(hb4_bytes, hb4_ops)[0],
        "queue_len_1080p": hd4_queue,
        "ms_cpp_m1_b8": cpp["m1_b8"]["ms"],
        "plain_ms_cpp_m1_b8": cpp["m1_b8"]["plain_ms"],
        "bound_ms_cpp_m1_b8": cpp["m1_b8"]["bound"][0],
        "bound_by_cpp_m1_b8": cpp["m1_b8"]["bound"][1],
        "queue_len_cpp_m1_b8": cpp["m1_b8"]["queue"],
        "ms_cpp_m0_canvas": cpp["m0_canvas"]["ms"],
        "plain_ms_cpp_m0_canvas": cpp["m0_canvas"]["plain_ms"],
        "bound_ms_cpp_m0_canvas": cpp["m0_canvas"]["bound"][0],
        "bound_by_cpp_m0_canvas": cpp["m0_canvas"]["bound"][1],
    }, {
        "name": "dense0_image",
        "route": "cuda",
        "source": "jda_tpu_torch/csrc/dense0_image.cu",
        "header": "jda_tpu_torch/csrc/dense0_walk.cuh",
        "replaces": "jda_tpu/ops/dense0.py:592",
        "also_replaces": ["jda_tpu/ops/dense0.py:753"],
        "launches": image_launches,
        "launches_per_batch": image_launches // len(unfused_imgs),  # of one image
        "launches_cpp": {k: v[1] for k, v in cpp["paths"].items()},
        "launches_trained_model": trained_launches[1],
        "max_abs_err": max(img_err, cpp["img_err"]),
        "ms": statistics.median([img_ms, img_ms2]),
        "head_ms": img_head,
        "survivors_ms": img_surv,
        "head_carts": C0,
        "queue_len": img_queue,
        "wrapper_ms": img_wrapper_ms,
        "plain_ms": img_plain_ms,
        "bound_ms": bound_of(ib_bytes, ib_ops)[0],
        "bound_by": bound_of(ib_bytes, ib_ops)[1],
        "library_ms": None,
        "dense0_filter_b1_ms": statistics.median([b1_ms, b1_ms2]),
        "ms_1080p": hd_ms,
        "bound_ms_1080p": bound_of(hb_bytes, hb_ops)[0],
        "queue_len_1080p": hd_queue,
        "ms_cpp_m1_image": cpp["m1_image"]["ms"],
        "plain_ms_cpp_m1_image": cpp["m1_image"]["plain_ms"],
        "bound_ms_cpp_m1_image": cpp["m1_image"]["bound"][0],
        "bound_by_cpp_m1_image": cpp["m1_image"]["bound"][1],
    }, tail_row, pyramid_row], "cpp_img_s": cpp["rates"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
