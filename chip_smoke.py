#!/usr/bin/env python3
"""Drive jda_tpu_torch on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

  1. build the CUDA kernels from jda_tpu_torch/csrc/ (one nvcc per source,
     all at once) and print the card;
  2. hold the dense stage-0 kernel (`dense0_filter`) against its plain
     PyTorch version on every VGA scale at B=16 and on 1080p win 24, 57 and
     88 at B=4, with and without packed leaf words: score, alive and nvis
     bit-equal, leaf words equal where alive;
  3. the main path: Detector.detect_stream over 4 chunks of 16 VGA images
     (a warm pass, then a timed pass) with the bench model (T=5, K=540,
     27 landmarks, depth 4, realistic drop profile), counting kernel
     launches;
  4. the same model against the native C library on 2 VGA images:
     identical boxes, scores within 2e-4, shapes within 2e-3;
  5. a 1080p stream of 4 frames at B=4;
  6. the kernel's time per VGA batch (CUDA events) beside its plain
     version's and its bound;
  7. hold the whole-ladder kernel of one image (`dense0_image`) against its
     plain version and against `dense0_filter` at B=1 on the full VGA
     ladder (4 images) and the full 1080p ladder (1 frame): score, alive
     and nvis bit-equal;
  8. the non-fused path at full width: Detector.detect under
     JDA_TPU_FUSED=0 on 4 VGA images and 1 1080p frame, bit-equal to the
     fused results of phases 3 and 5, one `dense0_image` launch per image;
  9. a multi-scale model of the same width through Detector.detect
     (pyramid, prefilter and stage loop of _run_batch) on 2 VGA images:
     the full ladder bit-equal to the port on the CPU, and against the
     native C library with the window pinned to 24 px, where every read of
     the C library stays inside its pyramid: identical boxes, scores within
     2e-4, shapes within 2e-3;
 10. `dense0_image` per VGA image and per 1080p frame (CUDA events) beside
     its plain version, its bound and the 14 `dense0_filter` launches at
     B=1 that compute the same.

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


def check_kernel(img, tabs, scales, depth):
    """Kernel against plain version on every given scale, LBF off and on.
    Returns the largest |score| difference (0.0 when bit-equal)."""
    import torch
    from jda_tpu_torch.ops import dense0 as D0

    err = 0.0
    for (win, step, ny, nx), (tabi, tabf) in zip(scales, tabs):
        for emit_lbf in (False, True):
            kw = dict(step=step, ny=ny, nx=nx, depth=depth, emit_lbf=emit_lbf)
            got = D0.scale_filter(img, tabi, tabf, **kw)
            want = D0.scale_filter_reference(img, tabi, tabf, **kw)
            torch.cuda.synchronize()
            err = max(err, float((got[0] - want[0]).abs().max()))
            for name, a, b in zip(("score", "alive", "nvis"), got, want):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"dense0_filter != plain: {name} at win {win} "
                        f"lbf={emit_lbf} B={img.shape[0]}"
                    )
            if emit_lbf:
                alive = want[1]
                if not torch.equal(got[3][alive], want[3][alive]):
                    raise AssertionError(
                        f"dense0_filter != plain: lbf words of alive windows "
                        f"at win {win} B={img.shape[0]}"
                    )
            log(f"  win {win:4d} step {step:2d} grid {ny}x{nx} lbf={int(emit_lbf)}: "
                f"bit-equal, alive {int(want[1].sum())} / {want[1].numel()}")
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


def image_bound(H, W, n_scales, n, K, node_n, nvis_sum, depth):
    """Least time for one `dense0_image` call: (bytes ms, operations ms)."""
    bytes_moved = (
        H * W  # the image, read once
        + n_scales * K * node_n * 16 + K * (node_n + 4) * 4 + n_scales * 16  # tables
        + n * (4 + 1 + 4)  # score, alive, nvis
    )
    # per visited cart: (depth-1) node steps of subtract, compare and two
    # index ops; add, subtract, divide and compare in the score chain
    ops = nvis_sum * ((depth - 1) * 4 + 4)
    return (bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3,
            bytes_moved, ops)


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
    err = check_kernel(vga_img, vga_tabs, vga_scales, depth)
    hd = [make_image(1080, 1920, seed=31 + i) for i in range(8)]
    _, _, _, hd_scales = enumerate_windows(1920, 1080, 1.25, 24, 1080)
    pick = [i for i, s in enumerate(hd_scales) if s[0] in (24, 57, 88)]
    if len(pick) != 3:
        raise AssertionError(f"1080p ladder lacks win 24/57/88: {hd_scales}")
    hd_sel = [hd_scales[i] for i in pick]
    hd_img = torch.as_tensor(np.stack(hd[:4]), device=dev)
    log("[2] dense0_filter vs plain, 1080p B=4, win 24/57/88")
    err = max(err, check_kernel(hd_img, scale_tables(det, hd_sel, dev), hd_sel, depth))
    log(f"[2] done in {time.perf_counter() - t0:.1f} s, max |score err| {err}")

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
    if launches != 4 * len(vga_scales):
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
    if hd_launches != len(hd_scales):
        raise AssertionError(f"1080p path launched dense0_filter {hd_launches} times")

    # -- 6. kernel time per VGA batch ------------------------------------------------
    prepared = []
    alive_n = nvis_sum = 0
    max_visits = []
    for (win, step, ny, nx), (tabi, tabf) in zip(vga_scales, vga_tabs):
        out = D0.scale_filter(vga_img, tabi, tabf, step=step, ny=ny, nx=nx,
                              depth=depth, emit_lbf=True)
        nodes = D0.kernel_nodes(tabi, step=step, W=640, depth=depth)
        prepared.append((nodes, tabf, out, step))
        alive_n += int(out[1].sum())
        nvis_sum += int(out[2].sum(dtype=torch.int64))
        max_visits.append(int(out[2].max()))

    def kernels():
        for nodes, tabf, out, step in prepared:
            D0.launch(vga_img, nodes, tabf, out, step=step, depth=depth)

    def wrapper():
        for (win, step, ny, nx), (tabi, tabf) in zip(vga_scales, vga_tabs):
            D0.scale_filter(vga_img, tabi, tabf, step=step, ny=ny, nx=nx,
                            depth=depth, emit_lbf=True)

    def plain():
        for (win, step, ny, nx), (tabi, tabf) in zip(vga_scales, vga_tabs):
            D0.scale_filter_reference(vga_img, tabi, tabf, step=step, ny=ny,
                                      nx=nx, depth=depth, emit_lbf=True)

    plain_ms = cuda_ms(plain, reps=1, groups=2)
    ms = cuda_ms(kernels, reps=10)
    wrapper_ms = cuda_ms(wrapper, reps=10)
    plain_ms2 = cuda_ms(plain, reps=1, groups=2)
    ms2 = cuda_ms(kernels, reps=10)
    # one launch lasts at least as long as its longest-living window's walk
    # through the carts: per-scale times against that window's cart count
    per_scale = [
        cuda_ms(lambda p=p: D0.launch(vga_img, p[0], p[1], p[2], step=p[3],
                                      depth=depth), reps=10, groups=3)
        for p in prepared
    ]
    log("[6] per scale (win: ms, most carts any window visited): " + ", ".join(
        f"{s[0]}: {t:.3f} ms, {v}" for s, t, v in zip(vga_scales, per_scale, max_visits)))
    K = model.K
    node_n = model.node_n
    B = 16
    bytes_moved = (
        B * 480 * 640  # the image, read once
        + len(vga_scales) * K * (node_n * 16 + (node_n + 4) * 4)  # tables
        + B * n_vga * (4 + 1 + 4)  # score, alive, nvis
        + alive_n * D0.lbf_words(K) * 4  # leaf words of the survivors
    )
    # per visited cart: (depth-1) node steps of subtract, compare and two
    # index ops; add, subtract, divide and compare in the score chain
    ops = nvis_sum * ((depth - 1) * 4 + 4)
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    log(f"[6] dense0_filter per VGA batch (B=16, {len(vga_scales)} launches): "
        f"{ms:.4f} / {ms2:.4f} ms kernels, {wrapper_ms:.4f} ms through the wrapper, "
        f"plain {plain_ms:.1f} / {plain_ms2:.1f} ms; bytes {bytes_moved} -> "
        f"{t_bytes:.4f} ms, ops {ops} -> {t_ops:.4f} ms; alive {alive_n}, "
        f"cart visits {nvis_sum}")

    # -- 7. dense0_image against its plain version, full ladders --------------------
    t0 = time.perf_counter()
    log("[7] dense0_image vs plain and vs dense0_filter at B=1, full ladders")
    img_err = 0.0
    for i in range(4):
        e, out_vga = check_image_kernel(vga_img[i], vga_tabs, vga_scales, depth, f"VGA image {i}")
        img_err = max(img_err, e)
    if out_vga[0].numel() != n_vga:
        raise AssertionError(f"dense0_image: {out_vga[0].numel()} windows, not {n_vga}")
    hd_tabs = scale_tables(det, hd_scales, dev)
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
        f"launches {image_launches} for {len(unfused_imgs)} images, dense0_filter {stray}")
    if image_launches != len(unfused_imgs) or stray != 0:
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
    prep_vga = D0.prepare_image(vga_tabs, meta=vga_scales, depth=depth, H=480, W=640)
    prep_hd = D0.prepare_image(hd_tabs, meta=hd_scales, depth=depth, H=1080, W=1920)
    img0, hd0 = vga_img[0], hd_img[0]
    b1 = []  # the same work as 14 dense0_filter launches at B=1
    for (win, step, ny, nx), nodes in zip(vga_scales, prep_vga.nodes):
        outs = (torch.empty((1, ny, nx), dtype=torch.float32, device=dev),
                torch.empty((1, ny, nx), dtype=torch.bool, device=dev),
                torch.empty((1, ny, nx), dtype=torch.int32, device=dev))
        b1.append((nodes, outs, step))

    def image_kernel():
        D0.launch_image(img0, prep_vga, out_vga)

    def image_wrapper():
        D0.stage0_filter_image(img0, vga_tabs, meta=vga_scales, depth=depth,
                               prepared=prep_vga)

    def image_plain():
        D0.stage0_filter_image_reference(img0, vga_tabs, meta=vga_scales, depth=depth)

    def per_scale_kernels():
        for nodes, outs, step in b1:
            D0.launch(img0[None], nodes, prep_vga.tabf, outs, step=step, depth=depth)

    img_plain_ms = cuda_ms(image_plain, reps=1, groups=2)
    img_ms = cuda_ms(image_kernel, reps=20)
    b1_ms = cuda_ms(per_scale_kernels, reps=5)
    img_wrapper_ms = cuda_ms(image_wrapper, reps=20)
    b1_ms2 = cuda_ms(per_scale_kernels, reps=5)
    img_ms2 = cuda_ms(image_kernel, reps=20)
    img_plain_ms2 = cuda_ms(image_plain, reps=1, groups=2)
    hd_ms = cuda_ms(lambda: D0.launch_image(hd0, prep_hd, out_hd), reps=10)
    nvis_vga = int(out_vga[2].sum(dtype=torch.int64))
    nvis_hd = int(out_hd[2].sum(dtype=torch.int64))
    ib_bytes, ib_ops, ib_nbytes, ib_nops = image_bound(
        480, 640, len(vga_scales), n_vga, K, node_n, nvis_vga, depth)
    hb_bytes, hb_ops, _, _ = image_bound(
        1080, 1920, len(hd_scales), n_hd, K, node_n, nvis_hd, depth)
    log(f"[10] dense0_image per VGA image (1 launch): {img_ms:.4f} / {img_ms2:.4f} ms kernel, "
        f"{img_wrapper_ms:.4f} ms through the wrapper, plain {img_plain_ms:.1f} / "
        f"{img_plain_ms2:.1f} ms, {len(b1)} dense0_filter launches at B=1 {b1_ms:.4f} / "
        f"{b1_ms2:.4f} ms; bytes {ib_nbytes} -> {ib_bytes:.5f} ms, ops {ib_nops} -> "
        f"{ib_ops:.5f} ms; cart visits {nvis_vga}, most by one window {int(out_vga[2].max())}")
    log(f"[10] dense0_image per 1080p frame (1 launch): {hd_ms:.4f} ms, bound "
        f"{max(hb_bytes, hb_ops):.5f} ms ({'bytes' if hb_bytes >= hb_ops else 'operations'}), "
        f"cart visits {nvis_hd}")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    log(card)
    log(json.dumps({"kernels": [{
        "name": "dense0_filter",
        "route": "cuda",
        "source": "jda_tpu_torch/csrc/dense0.cu",
        "replaces": "jda_tpu/ops/dense0.py:833",
        "also_replaces": ["jda_tpu/ops/dense0.py:1063", "jda_tpu/ops/dense0.py:1253"],
        "launches": launches,
        "launches_per_batch": len(vga_scales),
        "max_abs_err": err,
        "ms": statistics.median([ms, ms2]),
        "wrapper_ms": wrapper_ms,
        "plain_ms": statistics.median([plain_ms, plain_ms2]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }, {
        "name": "dense0_image",
        "route": "cuda",
        "source": "jda_tpu_torch/csrc/dense0_image.cu",
        "replaces": "jda_tpu/ops/dense0.py:592",
        "also_replaces": ["jda_tpu/ops/dense0.py:753"],
        "launches": image_launches,
        "launches_per_image": 1,
        "max_abs_err": img_err,
        "ms": statistics.median([img_ms, img_ms2]),
        "wrapper_ms": img_wrapper_ms,
        "plain_ms": statistics.median([img_plain_ms, img_plain_ms2]),
        "bound_ms": max(ib_bytes, ib_ops),
        "bound_by": "bytes" if ib_bytes >= ib_ops else "operations",
        "library_ms": None,
        "dense0_filter_b1_ms": statistics.median([b1_ms, b1_ms2]),
        "ms_1080p": hd_ms,
        "bound_ms_1080p": max(hb_bytes, hb_ops),
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
