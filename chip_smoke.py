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
     its plain version, its bound and the 14 per-scale calls that compute
     the same; the time of its head and survivor phases, the survivor
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
     and that batch through `detect_batch` against each image alone.

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

    plain_ms = cuda_ms(plain, reps=1, groups=2)
    ms = cuda_ms(ladder, reps=20)
    per_scale_ms = cuda_ms(per_scale, reps=5)
    wrapper_ms = cuda_ms(wrapper, reps=20)
    per_scale_ms2 = cuda_ms(per_scale, reps=5)
    ms2 = cuda_ms(ladder, reps=20)
    plain_ms2 = cuda_ms(plain, reps=1, groups=2)
    head_ms, surv_ms, queue_len = phase_ms(launch16, scr16, C0)
    alive_n = int(out16[1].sum())
    nvis_sum = int(out16[2].sum(dtype=torch.int64))
    t_bytes, t_ops, bytes_moved, ops = ladder_bound(
        16, 480, 640, len(vga_scales), n_vga, K, node_n, nvis_sum, depth,
        lbf_bytes=alive_n * D0.lbf_words(K) * 4)
    log(f"[6] dense0_filter per VGA batch (B=16, LBF on, 2 launches, head of {C0} carts): "
        f"{ms:.4f} / {ms2:.4f} ms kernels (head {head_ms:.4f}, survivors {surv_ms:.4f}), "
        f"{wrapper_ms:.4f} ms through the wrapper, {len(singles)} per-scale calls "
        f"{per_scale_ms:.4f} / {per_scale_ms2:.4f} ms, plain {plain_ms:.1f} / "
        f"{plain_ms2:.1f} ms; bytes {bytes_moved} -> {t_bytes:.4f} ms, ops {ops} -> "
        f"{t_ops:.4f} ms; queue {queue_len} of {16 * n_vga} windows, alive {alive_n}, "
        f"cart visits {nvis_sum}, most by one window {int(out16[2].max())}")
    # where to cut the head: windows still alive after C carts, and the time
    # (with leaf words every window alive after the head queues)
    head_sweep(6, "VGA B=16, leaf words", launch16, out16, scr16)
    out4 = ladder_outputs(4, prep_hd)
    scr4 = D0.walk_scratch(4, prep_hd)

    def launch4(**kw):
        D0.launch(hd_img, prep_hd, out4, **kw)

    hd4_ms = cuda_ms(lambda: launch4(scratch=scr4), reps=10)
    hd4_head, hd4_surv, hd4_queue = phase_ms(launch4, scr4, C0)
    hd4_alive = int(out4[1].sum())
    hd4_nvis = int(out4[2].sum(dtype=torch.int64))
    hb4_bytes, hb4_ops, _, _ = ladder_bound(
        4, 1080, 1920, len(hd_scales), n_hd, K, node_n, hd4_nvis, depth,
        lbf_bytes=hd4_alive * D0.lbf_words(K) * 4)
    log(f"[6] dense0_filter per 1080p batch (B=4, LBF on, 2 launches): {hd4_ms:.4f} ms "
        f"(head {hd4_head:.4f}, survivors {hd4_surv:.4f}), bound "
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

    img_plain_ms = cuda_ms(image_plain, reps=1, groups=2)
    img_ms = cuda_ms(image_kernel, reps=20)
    b1_ms = cuda_ms(per_scale_b1, reps=5)
    img_wrapper_ms = cuda_ms(image_wrapper, reps=20)
    b1_ms2 = cuda_ms(per_scale_b1, reps=5)
    img_ms2 = cuda_ms(image_kernel, reps=20)
    img_plain_ms2 = cuda_ms(image_plain, reps=1, groups=2)
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
        f"{img_wrapper_ms:.4f} ms through the wrapper, plain {img_plain_ms:.1f} / "
        f"{img_plain_ms2:.1f} ms, {len(singles)} per-scale dense0_filter calls at B=1 "
        f"{b1_ms:.4f} / {b1_ms2:.4f} ms; bytes {ib_nbytes} -> {ib_bytes:.5f} ms, ops "
        f"{ib_nops} -> {ib_ops:.5f} ms; cart visits {nvis_vga}, most by one window "
        f"{int(out_vga[2].max())}")
    log(f"[10] dense0_image per 1080p frame (2 launches): {hd_ms:.4f} ms (head "
        f"{hd_head:.4f}, survivors {hd_surv:.4f}, queue {hd_queue}), bound "
        f"{bound_of(hb_bytes, hb_ops)[0]:.5f} ms ({bound_of(hb_bytes, hb_ops)[1]}), "
        f"cart visits {nvis_hd}")
    head_sweep(10, "VGA image", launch_vga, out_vga, scr_vga)
    head_sweep(10, "1080p frame", launch_hd, out_hd, scr_hd)
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
        "max_abs_err": err,
        "ms": statistics.median([ms, ms2]),
        "head_ms": head_ms,
        "survivors_ms": surv_ms,
        "head_carts": C0,
        "queue_len": queue_len,
        "wrapper_ms": wrapper_ms,
        "per_scale_calls_ms": statistics.median([per_scale_ms, per_scale_ms2]),
        "plain_ms": statistics.median([plain_ms, plain_ms2]),
        "bound_ms": bound_of(t_bytes, t_ops)[0],
        "bound_by": bound_of(t_bytes, t_ops)[1],
        "library_ms": None,
        "ms_1080p": hd4_ms,
        "bound_ms_1080p": bound_of(hb4_bytes, hb4_ops)[0],
        "queue_len_1080p": hd4_queue,
    }, {
        "name": "dense0_image",
        "route": "cuda",
        "source": "jda_tpu_torch/csrc/dense0_image.cu",
        "header": "jda_tpu_torch/csrc/dense0_walk.cuh",
        "replaces": "jda_tpu/ops/dense0.py:592",
        "also_replaces": ["jda_tpu/ops/dense0.py:753"],
        "launches": image_launches,
        "launches_per_batch": image_launches // len(unfused_imgs),  # of one image
        "max_abs_err": img_err,
        "ms": statistics.median([img_ms, img_ms2]),
        "head_ms": img_head,
        "survivors_ms": img_surv,
        "head_carts": C0,
        "queue_len": img_queue,
        "wrapper_ms": img_wrapper_ms,
        "plain_ms": statistics.median([img_plain_ms, img_plain_ms2]),
        "bound_ms": bound_of(ib_bytes, ib_ops)[0],
        "bound_by": bound_of(ib_bytes, ib_ops)[1],
        "library_ms": None,
        "dense0_filter_b1_ms": statistics.median([b1_ms, b1_ms2]),
        "ms_1080p": hd_ms,
        "bound_ms_1080p": bound_of(hb_bytes, hb_ops)[0],
        "queue_len_1080p": hd_queue,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
