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
     version's and its bound.

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
    _build.build_all(["dense0"])
    log(f"[1] built dense0 in {time.perf_counter() - t0:.1f} s")
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
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
