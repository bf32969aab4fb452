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
     launches;
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
     (pyramid, prefilter and stage loop of _run_batch) on 2 VGA images:
     the full ladder bit-equal to the port on the CPU, and against the
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
     `dense0_filter` launches, bit-equal to the same on the CPU.

The last lines are the card (nvidia-smi name and power limit), a
{"kernels": [...]} JSON line, and {"ok": true, "device": {...}}.  Without a
CUDA device it exits non-zero and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
FP32_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
BENCH_KW = dict(scale=1.25, min_size=24, max_size=-1, th=-0.5)


def make_image(h, w, seed):
    """Blocky texture plus noise, as the repository's bench draws it."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    noise = rng.normal(0, 12, (h, w))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


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


def _face(rng, size):
    """A face patch as the flagship model's training scenes draw one: dark
    landmark blobs, a forehead band and cheek highlights on noise, band
    limited."""
    base, spread = int(rng.integers(85, 175)), int(rng.integers(15, 45))
    img = rng.integers(base - spread, base + spread, (size, size)).astype(np.float64)
    dark, r = int(rng.integers(10, 60)), max(1, size // 24)
    for gx, gy in FACE27:
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
    from jda_tpu_torch.ops import dense0 as D0

    err = 0.0
    for emit_lbf in (False, True):
        before = D0.scale_filter.launches
        got = D0.stage0_filter_all_scales(img, tabs, meta=scales, depth=depth,
                                          emit_lbf=emit_lbf)
        err = max(err, compare_filter(got, want, emit_lbf, f"{label} lbf={emit_lbf}"))
        if D0.scale_filter.launches != before + 2:
            raise AssertionError(f"{label}: {D0.scale_filter.launches - before} launches")
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
    from jda_tpu_torch.fddb import run_fddb
    from jda_tpu_torch.ops import dense0 as D0

    root = os.path.dirname(os.path.abspath(__file__))
    flag = jt.load_model(os.path.join(root, "models", "flagship_synth.model"))
    K, node_n = flag.K, flag.node_n
    nw = D0.lbf_words(K)
    got = {}

    def reset():
        torch.cuda.synchronize()
        D0.scale_filter.launches = 0
        D0.stage0_filter_image.launches = 0

    def counts():
        torch.cuda.synchronize()
        return D0.scale_filter.launches, D0.stage0_filter_image.launches

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
    reset()
    t = time.perf_counter()
    res_b = cpp1.detect_batch(imgs[:8])
    launches_b = counts()
    dt_b = time.perf_counter() - t
    cpp1.detect(imgs[8])
    reset()
    t = time.perf_counter()
    res_1 = [cpp1.detect(g) for g in imgs[:2]]
    launches_1 = counts()
    dt_1 = time.perf_counter() - t
    cpp0.detect(imgs[8])
    reset()
    t = time.perf_counter()
    res_0 = [cpp0.detect(g) for g in imgs[:2]]
    launches_0 = counts()
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
    reset()
    t = time.perf_counter()
    r_ms = cpp_ms.detect(imgs[0])
    launches_ms = counts()
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
            reset()
            stats = run_fddb(flag, jt.Config(fddb_detect_method=method, fddb_dir=tmp),
                             folds=[1, 2], out_dir=out_dir, imread=by_path.get)
            launches = counts()
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
    the C++-semantics detector.  Returns dense0_filter's launches in 18."""
    import torch
    import jda_tpu_torch as jt
    from jda_tpu_torch.cascador import CppDetector
    from jda_tpu_torch.data import DataSet
    from jda_tpu_torch.ops import dense0 as D0

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
    if a.rng.integers(1 << 62) != b.rng.integers(1 << 62):
        raise AssertionError("[16] training: the random streams diverged")
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
    D0.scale_filter.launches = D0.stage0_filter_image.launches = 0
    t = time.perf_counter()
    res = cpp.detect_batch(imgs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    launches = (D0.scale_filter.launches, D0.stage0_filter_image.launches)
    if launches != (2, 0):
        raise AssertionError(f"[18] trained model: launches {launches}, not (2, 0)")
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
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jda_tpu_torch as jt
    from jda_tpu_torch import native
    from jda_tpu_torch.detect import enumerate_windows
    from jda_tpu_torch.ops import _build
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
    _build.build_all(["dense0", "dense0_image"])
    log(f"[1] built dense0 and dense0_image in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")

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
    D0.scale_filter.launches = 0
    t0 = time.perf_counter()
    res = det.detect_stream(vga, batch=16, **BENCH_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = D0.scale_filter.launches
    stats = det.last_stats
    log(f"[3] VGA detect_stream: {len(vga)} images in {dt:.3f} s = "
        f"{len(vga) / dt:.2f} img/s, {len(vga) * n_vga / dt:.4g} windows/s "
        f"({n_vga} windows/image)")
    log(f"[3] last batch counts {stats['counts']} total_nvis {stats['total_nvis']}, "
        f"dense0_filter launches {launches}")
    if launches != 4 * 2:  # head and survivor kernel, once per batch
        raise AssertionError(f"main path launched dense0_filter {launches} times")
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
    D0.scale_filter.launches = 0
    t0 = time.perf_counter()
    res_hd = det.detect_stream(hd[:4], batch=4, **BENCH_KW)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    hd_launches = D0.scale_filter.launches
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
        D0.stage0_filter_image.launches = 0
        D0.scale_filter.launches = 0
        t0 = time.perf_counter()
        unfused_res = [det.detect(g, **BENCH_KW) for g in unfused_imgs[:4]]
        torch.cuda.synchronize()
        dt_vga = time.perf_counter() - t0
        t0 = time.perf_counter()
        unfused_res.append(det.detect(unfused_imgs[4], **BENCH_KW))
        torch.cuda.synchronize()
        dt_hd = time.perf_counter() - t0
        image_launches = D0.stage0_filter_image.launches
        stray = D0.scale_filter.launches
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

    # -- 9. a multi-scale model: pyramid, prefilter, stage loop ----------------------
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
        for i in range(2):
            t0 = time.perf_counter()
            r = ms_det.detect(vga[i], **BENCH_KW)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
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
    trained_launches = train_phases(dev, card)
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
    }], "cpp_img_s": cpp["rates"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
