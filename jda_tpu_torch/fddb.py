"""FDDB benchmark harness (`jda fddb`, src/test.cpp:73-235).

PyTorch counterpart of the JAX package's fddb.py.  Runs the detector over
the FDDB folds and writes `fold-XX-out.txt` result files in the rect format
consumed by the standard FDDB evaluation tools (README.md:115-136):

    <image path>
    <n detections>
    <x y w h score> * n

Statistics mirror DetectionStatisic aggregation (windows scanned / face /
non-face / mean carts to reject), per fold and overall.  The reference
parallelizes over folds with OpenMP (test.cpp:100); here the images of a
fold are the device batch.

Images are read by `imread(path)`, which returns the gray uint8 image or
None for a file it cannot read; the default is OpenCV's imread and
BGR-to-gray conversion, as in the JAX package.  Pass another reader where
OpenCV is not installed: the harness never switches reader on its own.
Annotated output images need OpenCV.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from jda_tpu_torch.cascador import CppDetector, DetectionStatistic
from jda_tpu_torch.config import Config
from jda_tpu_torch.params import CascadeParams
from jda_tpu_torch.utils import log, require_cv2


def read_fold(fddb_dir: str, fold: int) -> List[str]:
    path = os.path.join(fddb_dir, "FDDB-folds", f"FDDB-fold-{fold:02d}.txt")
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def read_ellipses(fddb_dir: str, fold: int) -> Dict[str, np.ndarray]:
    """Ground-truth ellipses (major minor angle cx cy score per face)."""
    path = os.path.join(
        fddb_dir, "FDDB-folds", f"FDDB-fold-{fold:02d}-ellipseList.txt"
    )
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        toks = f.read().split("\n")
    i = 0
    while i < len(toks):
        name = toks[i].strip()
        if not name:
            i += 1
            continue
        n = int(toks[i + 1])
        faces = [
            [float(v) for v in toks[i + 2 + j].split()] for j in range(n)
        ]
        out[name] = np.asarray(faces)
        i += 2 + n
    return out


def _cv2_imread_gray(cv2) -> Callable[[str], Optional[np.ndarray]]:
    def imread(path: str) -> Optional[np.ndarray]:
        img = cv2.imread(path)
        return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)

    return imread


def _annotate(cv2, c: Config, img, gt, rects, scores, shapes, path: str) -> None:
    """Draw the ground truth, the detections, their scores and landmarks
    (test.cpp:170-200) and write the image."""
    for e in gt:
        cv2.ellipse(
            img,
            (int(e[3]), int(e[4])),
            (int(e[0]), int(e[1])),
            e[2] / math.pi * 180.0,
            0.0,
            360.0,
            (255, 0, 0),
            2,
        )
    for r, s in zip(rects, scores):
        cv2.rectangle(
            img,
            (int(r[0]), int(r[1])),
            (int(r[0] + r[2]), int(r[1] + r[3])),
            (0, 0, 255),
            3,
        )
        if c.fddb_draw_score:  # test.cpp:191-194
            cv2.putText(
                img,
                f"{s:.4f}",
                (int(r[0]), int(r[1])),
                cv2.FONT_HERSHEY_PLAIN,
                1,
                (0, 255, 0),
                2,
            )
    if c.fddb_draw_shape:  # test.cpp:196-200
        for sh in shapes:
            for k in range(len(sh) // 2):
                cv2.circle(
                    img, (int(sh[2 * k]), int(sh[2 * k + 1])), 3, (0, 255, 0), -1
                )
    cv2.imwrite(path, img)


def run_fddb(
    params: CascadeParams,
    c: Config,
    folds: Optional[List[int]] = None,
    out_dir: Optional[str] = None,
    annotate: bool = False,
    imread: Optional[Callable[[str], Optional[np.ndarray]]] = None,
    device: Union[str, torch.device, None] = None,
) -> Dict:
    """Run the benchmark; returns aggregate stats and per-fold timings.

    `imread` reads one image path to its gray uint8 image (None: skip the
    file); the default is OpenCV's, and without OpenCV the default raises
    ImportError.  `device` as for `CppDetector`."""
    cv2 = require_cv2("run_fddb: annotate=True draws with OpenCV") if annotate else None
    if imread is None:
        imread = _cv2_imread_gray(require_cv2(
            "run_fddb: imread=None reads the images with OpenCV; pass imread= (a "
            "function from an image path to its gray uint8 image, or None) "
            "to read them another way"
        ))
    det = CppDetector(params, c, device=device)
    folds = folds or list(range(1, 11))
    out_dir = out_dir or os.path.join(c.fddb_dir, "result")
    os.makedirs(out_dir, exist_ok=True)
    prefix = os.path.join(c.fddb_dir, "images")

    # load every fold up front; the images of a fold are the device batch.
    # The canonical plane is computed over the whole sweep, so every batch
    # of every fold shares one plan.
    by_fold = {}
    for i in folds:
        loaded = []
        for path in read_fold(c.fddb_dir, i):
            full = os.path.join(prefix, path + ".jpg")
            gray = imread(full)
            if gray is None:
                log(f"Can not open {full}, Skip it")
                continue
            loaded.append((path, full, gray))
        by_fold[i] = loaded
    B = int(os.environ.get("JDA_TPU_FDDB_BATCH", "8"))
    canon = None
    if any(by_fold.values()):
        mh = max(g.shape[0] for ld in by_fold.values() for _, _, g in ld)
        mw = max(g.shape[1] for ld in by_fold.values() for _, _, g in ld)
        canon = (-(-mh // 128) * 128, -(-mw // 128) * 128)

    batched = (
        c.fddb_detect_method != 0
        and det.det.single_scale
        and det.det._fused_enabled()
    )
    total_stat = DetectionStatistic()
    total_images = 0
    total_time = 0.0
    fold_stats = []
    for i in folds:
        log(f"Testing FDDB-fold-{i:02d}")
        fold_stat = DetectionStatistic()
        lines = []
        n_img = 0
        t_fold = 0.0
        gt = {}
        if annotate:
            try:
                gt = read_ellipses(c.fddb_dir, i)
            except OSError:
                gt = {}
        loaded = by_fold[i]
        results = []
        for b0 in range(0, len(loaded), B):
            grays = [g for _, _, g in loaded[b0 : b0 + B]]
            t0 = time.perf_counter()
            if batched and len(loaded) > 1:
                outs = det._detect_batch_m1(grays, canon=canon)
            else:
                outs = [det.detect(g) for g in grays]
            t_fold += time.perf_counter() - t0
            results.extend(outs)
        for (path, full, gray), (rects, scores, shapes, stat) in zip(loaded, results):
            n_img += 1
            fold_stat.add(stat)
            lines.append(path)
            lines.append(str(len(rects)))
            for r, s in zip(rects, scores):
                # printf("%d %d %d %d %lf\n", ...) — test.cpp:163
                lines.append(f"{r[0]} {r[1]} {r[2]} {r[3]} {s:.6f}")
            if annotate:
                img = cv2.imread(full)
                if img is None:
                    img = cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR)
                _annotate(
                    cv2, c, img, gt.get(path, []), rects, scores, shapes,
                    os.path.join(out_dir, f"{i:02d}_{n_img:03d}_{len(rects):02d}.jpg"),
                )
        with open(os.path.join(out_dir, f"fold-{i:02d}-out.txt"), "w") as f:
            f.write("\n".join(lines) + ("\n" if lines else ""))
        log(
            f"fold {i:02d}: {n_img} images, {n_img / max(t_fold, 1e-9):.2f} "
            f"img/s; windows {fold_stat.patch_n}, faces "
            f"{fold_stat.face_patch_n}, avg reject carts "
            f"{fold_stat.average_cart_n:.2f}"
        )
        total_stat.add(fold_stat)
        total_images += n_img
        total_time += t_fold
        fold_stats.append({"fold": i, "images": n_img, "seconds": t_fold})

    log(
        f"ALL: {total_images} images in {total_time:.1f}s "
        f"({total_images / max(total_time, 1e-9):.2f} img/s); windows "
        f"{total_stat.patch_n}, avg reject carts {total_stat.average_cart_n:.2f}"
    )
    return {
        "images": total_images,
        "seconds": total_time,
        "images_per_sec": total_images / max(total_time, 1e-9),
        "windows": total_stat.patch_n,
        "face_windows": total_stat.face_patch_n,
        "average_cart_n": total_stat.average_cart_n,
        "folds": fold_stats,
    }
