#!/usr/bin/env python3
"""Where the time goes in jda_tpu_torch's detection path, on one CUDA card.

    python3 scripts/profile_torch_detect.py

For the bench shapes (VGA at B=16, 1080p at B=4; T=5/K=540 synthetic model
with the realistic drop profile; scale 1.25, min 24, th -0.5) it prints

  * host wall time per phase of one fused batch: upload, dense stage-0
    filter, compactions, stage-0 leaf unpack, cart chunks, regressions and
    the host harvest (each phase synchronises the device before and after,
    so the phases add up to a slower batch than the unsynchronised one);
  * from torch.profiler over one unsynchronised batch: the device's busy
    time (sum of kernel times), the number of kernels launched and the
    device's idle share of the batch's wall time; beside it the launches
    of the hand-written stage-0 kernels in that batch (`dense0_filter`,
    `dense0_image`: a head and a survivor kernel per call);
  * the same two readings for the non-fused path (JDA_TPU_FUSED=0), one
    image per call: `Detector.detect` of the bench model on one VGA image
    and one 1080p frame (dense filter of the whole ladder in one
    `dense0_image` call, then cascade_full on the survivors), and of a
    multi-scale model of the same width on one VGA image (pyramid,
    prefilter and stage loop of `_run_batch`);
  * the card, as nvidia-smi gives its name and power limit.
"""

import collections
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KW = dict(scale=1.25, min_size=24, max_size=-1, th=-0.5)


def make_image(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    noise = rng.normal(0, 12, (h, w))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def phase_times(det, imgs, unfused=False):
    """Synchronised host time per instrumented phase of one batch (fused)
    or of one `detect` call per image (non-fused)."""
    import torch
    from jda_tpu_torch.detect import Detector
    from jda_tpu_torch.ops import cascade as C
    from jda_tpu_torch.ops import dense0 as D0
    from jda_tpu_torch.ops import fused as F
    from jda_tpu_torch.ops import nms as NMS
    from jda_tpu_torch.ops import resize as R

    DT = sys.modules[Detector.__module__]
    acc = collections.OrderedDict()
    patches = [
        (D0, "stage0_filter_all_scales", "dense stage-0 filter"),
        (F, "compact", "compaction"),
        (F, "unpack_lbf", "stage-0 leaf unpack"),
        (C, "carts_descend", "tree descent (stages 1-4)"),
        (C, "score_chain", "score chain (stages 1-4)"),
        (C, "apply_regression", "exact regression (stages 0-4)"),
        (Detector, "_upload", "upload"),
        (Detector, "_harvest_batch", "harvest + NMS (host)"),
    ]
    if unfused:
        patches = [
            (R, "pyramid_c", "pyramid (host)"),
            (DT, "window_geometry", "window geometry (host)"),
            (Detector, "_dense_filter", "dense stage-0 filter (dense0_image)"),
            (C, "carts_descend", "tree descent"),
            (C, "score_chain", "score chain"),
            (C, "apply_regression", "exact regression"),
            (NMS, "nms_c", "NMS (host)"),
        ]
    saved = []
    for mod, name, label in patches:
        fn = getattr(mod, name)
        saved.append((mod, name, fn))

        def timed(*a, _fn=fn, _label=label, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize()
            acc[_label] = acc.get(_label, 0.0) + time.perf_counter() - t0
            return out

        setattr(mod, name, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(det, imgs, unfused)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return total, acc


def run(det, imgs, unfused):
    if unfused:
        return [det.detect(g, **KW) for g in imgs]
    return det.detect_batch(imgs, **KW)


def device_busy(det, imgs, unfused=False):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from jda_tpu_torch.ops import dense0 as D0

    before = D0.scale_filter.launches + D0.stage0_filter_image.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(det, imgs, unfused)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = 0.0
    kernels = 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            busy_us += ev.device_time_total
            kernels += 1
    dense = D0.scale_filter.launches + D0.stage0_filter_image.launches - before
    return wall, busy_us / 1e6, kernels, dense


def main():
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_detect: no CUDA device", file=sys.stderr)
        return 2
    import jda_tpu_torch as jt

    model = jt.synthetic_model(
        T=5, K=540, landmark_n=27, seed=7,
        drop_profile=jt.realistic_drop_profile(5, 540),
    )
    det = jt.Detector(model)
    ms_det = jt.Detector(jt.synthetic_model(
        T=5, K=540, landmark_n=27, seed=7, multi_scale=True,
        drop_profile=jt.realistic_drop_profile(5, 540),
    ))
    cells = (
        ("VGA B=16", det, (480, 640, 16, 3), False),
        ("1080p B=4", det, (1080, 1920, 4, 31), False),
        ("non-fused VGA, 1 image", det, (480, 640, 1, 3), True),
        ("non-fused 1080p, 1 frame", det, (1080, 1920, 1, 31), True),
        ("non-fused multi-scale VGA, 1 image", ms_det, (480, 640, 1, 3), True),
    )
    for label, d, (h, w, B, seed), unfused in cells:
        os.environ["JDA_TPU_FUSED"] = "0" if unfused else "1"
        imgs = [make_image(h, w, seed + i) for i in range(B)]
        run(d, imgs, unfused)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(d, imgs, unfused)
        torch.cuda.synchronize()
        plain = time.perf_counter() - t0
        total, acc = phase_times(d, imgs, unfused)
        wall, busy, kernels, dense = device_busy(d, imgs, unfused)
        print(f"{label}: {plain * 1e3:.1f} ms unsynchronised, "
              f"{total * 1e3:.1f} ms with per-phase syncs; counts "
              f"{d.last_stats.get('counts') if not unfused else 'n/a'}")
        for k, v in acc.items():
            print(f"  {k:36s} {v * 1e3:9.1f} ms  {100 * v / total:5.1f} %")
        print(f"  {'other (host glue, copies)':36s} {(total - sum(acc.values())) * 1e3:9.1f} ms")
        print(f"  profiler: wall {wall * 1e3:.1f} ms, device busy {busy * 1e3:.1f} ms "
              f"({kernels} kernels, {dense} of them the stage-0 filter's), "
              f"idle share {1 - busy / wall:.3f}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
