"""Held-out quality evaluation on the port: the flagship model against
scenes it was not trained on (the counterpart of scripts/eval_holdout.py,
function for function).

Six families of 24 VGA scenes: `base` (scripts/eval_synth_scenes_torch.
build_scenes from seed 777), four perturbations of those scenes along axes
the training generator never produced (`photometric`: gamma, contrast and
brightness; `blur`: an extra Gaussian blur of sigma 1.0-1.8; `occlusion`:
a clutter patch over 15-25 % of each face; `gradient`: an illumination
ramp), and `texture_bg` (faces over correlated-noise backgrounds, from
seed 778).  Each family gets its own threshold sweep (recall, FP per scene,
alignment error).  OpenCV's calls are the port's models
(`ops/resize.cv2_resize_cubic`, `ops/resize.cv2_gaussian_blur_f32`), so no
OpenCV is needed.

The JAX script seeds each perturbed family with `hash(fam) % 2**32`, and
Python salts str hashes per process, so those four families differ from
run to run; `main()` keeps that seeding (so both scripts agree within one
process), and `build_families(family_seeds=)` takes fixed seeds.

Usage:
  python scripts/eval_holdout_torch.py [models/flagship_synth.model]
      [models/scene_eval_holdout_torch.json] [--device cpu]

The default output is models/scene_eval_holdout_torch.json; it never
writes models/scene_eval_holdout.json, the JAX package's record.
JDA_TPU_EVAL_SCALE sets the ladder (default 1.25), JDA_TPU_EVAL_SCENES
the scenes per family (default 24).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from jda_tpu_torch.ops.resize import cv2_gaussian_blur_f32, cv2_resize_cubic  # noqa: E402
from scripts.eval_synth_scenes_torch import SWEEP, build_scenes, iou, sweep  # noqa: E402

PERTURBED = ("photometric", "blur", "occlusion", "gradient")
FAMILIES = ("base",) + PERTURBED + ("texture_bg",)
JAX_RECORD = os.path.join(ROOT, "models", "scene_eval_holdout.json")


def _smooth_noise(rng, h, w, cells=12):
    """Correlated (low-frequency) texture: upsampled coarse noise — a
    background statistic the mining corpus never contained."""
    coarse = rng.integers(40, 215, (cells, cells)).astype(np.uint8)
    return cv2_resize_cubic(coarse, w, h)


def perturb(rng, scene, gt_boxes, family):
    """Return a perturbed copy of `scene` for the given family."""
    img = scene.astype(np.float32)
    if family == "photometric":
        gamma = rng.choice([rng.uniform(0.6, 0.8), rng.uniform(1.3, 1.6)])
        img = 255.0 * (img / 255.0) ** gamma
        img = (img - 127.5) * rng.uniform(0.7, 1.3) + 127.5
        img += rng.uniform(-30, 30)
    elif family == "blur":
        sigma = rng.uniform(1.0, 1.8)
        img = cv2_gaussian_blur_f32(img, sigma)
    elif family == "occlusion":
        for (x0, y0, s) in gt_boxes:
            side = int(s * rng.uniform(0.38, 0.5))  # area 15-25%
            ox = int(rng.integers(x0, max(x0 + s - side, x0 + 1)))
            oy = int(rng.integers(y0, max(y0 + s - side, y0 + 1)))
            img[oy : oy + side, ox : ox + side] = rng.integers(
                30, 220, (min(side, img.shape[0] - oy), min(side, img.shape[1] - ox))
            )
    elif family == "gradient":
        h, w = img.shape
        gx = np.linspace(0, 1, w)[None, :]
        gy = np.linspace(0, 1, h)[:, None]
        a, b = rng.uniform(-0.4, 0.4, 2)
        ramp = 0.95 + a * (gx - 0.5) + b * (gy - 0.5)
        img *= np.clip(ramp, 0.55, 1.35)
    return np.clip(img, 0, 255).astype(np.uint8)


def build_texture_scenes(rng, n_scenes):
    """Faces (training generator) composited on correlated-noise
    backgrounds the cascade never mined against."""
    from scripts.train_flagship_torch import make_face

    scenes, gt = [], []
    for _ in range(n_scenes):
        scene = _smooth_noise(rng, 480, 640)
        boxes, lms = [], []
        for _ in range(rng.integers(1, 4)):
            size = int(rng.integers(56, 160))
            face, lm = make_face(rng, size)
            for _try in range(20):
                x0 = int(rng.integers(0, 640 - size))
                y0 = int(rng.integers(0, 480 - size))
                if all(iou((x0, y0, size), b) < 0.1 for b in boxes):
                    break
            scene[y0 : y0 + size, x0 : x0 + size] = face
            boxes.append((x0, y0, size))
            abs_lm = lm.copy()
            abs_lm[0::2] = x0 + abs_lm[0::2] * size
            abs_lm[1::2] = y0 + abs_lm[1::2] * size
            lms.append(abs_lm)
        scenes.append(scene)
        gt.append((boxes, lms))
    return scenes, gt


def build_families(n_scenes, family_seeds=None):
    """The six families, each (scenes, ground truth), in FAMILIES order.

    `family_seeds` maps each perturbed family to the seed of its random
    stream; None takes the JAX script's `hash(fam) % 2**32`, which changes
    from process to process."""
    base_scenes, base_gt = build_scenes(np.random.default_rng(777), n_scenes)
    families = {"base": (base_scenes, base_gt)}
    for fam in PERTURBED:
        seed = hash(fam) % (2**32) if family_seeds is None else family_seeds[fam]
        fam_rng = np.random.default_rng(seed)
        families[fam] = (
            [perturb(fam_rng, s, gtb, fam) for s, (gtb, _) in zip(base_scenes, base_gt)],
            base_gt,
        )
    families["texture_bg"] = build_texture_scenes(np.random.default_rng(778), n_scenes)
    return families


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="models/flagship_synth.model")
    ap.add_argument("out", nargs="?", default="models/scene_eval_holdout_torch.json")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; without one this raises)",
    )
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(JAX_RECORD):
        raise ValueError(f"{args.out} is the JAX package's record; write elsewhere")
    from jda_tpu_torch import Detector, load_model

    ladder_scale = float(os.environ.get("JDA_TPU_EVAL_SCALE", "1.25"))
    n_scenes = int(os.environ.get("JDA_TPU_EVAL_SCENES", "24"))
    m = load_model(args.model)
    det = Detector(m, rounding=True, device=args.device)

    t0 = time.perf_counter()
    families = build_families(n_scenes)
    t_build = time.perf_counter() - t0
    payload = {
        "model": args.model,
        "scenes_per_family": n_scenes,
        "ladder_scale": ladder_scale,
        "families": {},
        "device": str(det.device),
        "seconds": {"build_scenes": t_build, "detect": {}},
    }
    for fam, (scenes, gt) in families.items():
        t0 = time.perf_counter()
        results = det.detect_stream(scenes, batch=8, th=SWEEP[0], scale=ladder_scale)
        payload["seconds"]["detect"][fam] = time.perf_counter() - t0
        pts = sweep(results, gt)
        payload["families"][fam] = pts
        # headline: best recall at fp/scene == 0, and recall at th=-0.5
        fp0 = [p for p in pts if p["fp_per_scene"] == 0.0]
        r0 = max((p["recall"] for p in fp0), default=0.0)
        rm = next((p for p in pts if p["th"] == -0.5), pts[0])
        print(
            f"{fam:12s} recall@fp0={r0:.3f}  "
            f"recall@-0.5={rm['recall']:.3f} "
            f"fp/scene@-0.5={rm['fp_per_scene']:.2f}"
        )
    secs = payload["seconds"]
    n_img = n_scenes * len(families)
    det_s = sum(secs["detect"].values())
    print(f"{n_img} scenes on {det.device}: built in {t_build:.2f} s, detected in "
          f"{det_s:.2f} s ({n_img / det_s:.2f} img/s, the first family builds the plan)")
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
