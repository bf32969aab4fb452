"""End-to-end quality proxy on the port: detect trained-model faces in
composed scenes (the counterpart of scripts/eval_synth_scenes.py).

Faces from the SAME generator the flagship model was trained on
(scripts/train_flagship_torch.py, byte-equal to scripts/train_flagship.py)
are composited at random scales/positions into textured scenes, detected
with the full batched pipeline under C++ rounding semantics
(Detector(rounding=True), the fused path on the card), and scored by
IoU-0.5 recall/precision at a sweep of score thresholds plus mean
inter-pupil-normalized alignment error of matched detections.  The scenes
are the JAX script's, byte for byte (`cv2.resize` is `ops/resize.
cv2_resize`), so the sweep is comparable with models/scene_eval.json.

Usage:
  python scripts/eval_synth_scenes_torch.py [models/flagship_synth.model]
      [out.json] [--device cpu]

Writes the sweep as JSON (default models/scene_eval_torch.json; it never
writes models/scene_eval.json, the JAX package's record) and prints a
per-threshold table.  JDA_TPU_EVAL_SCALE sets the ladder (default 1.25).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_SCENES = 24
# one detection pass at the lowest threshold; the sweep filters by score
# post-NMS (standard discROC generation)
SWEEP = [-3.0, -2.0, -1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 2.0, 4.0]
JAX_RECORD = os.path.join(ROOT, "models", "scene_eval.json")


def iou(a, b):
    ax0, ay0, aw = a
    bx0, by0, bw = b
    x0 = max(ax0, bx0)
    y0 = max(ay0, by0)
    x1 = min(ax0 + aw, bx0 + bw)
    y1 = min(ay0 + aw, by0 + bw)
    if x1 <= x0 or y1 <= y0:
        return 0.0
    inter = (x1 - x0) * (y1 - y0)
    return inter / (aw * aw + bw * bw - inter)


def build_scenes(rng, n_scenes):
    from jda_tpu_torch.ops.resize import cv2_resize
    from scripts.train_flagship_torch import make_bg, make_face

    scenes, gt = [], []
    for _ in range(n_scenes):
        scene = make_bg(rng, 480)[:, :480]
        scene = cv2_resize(scene, 640, 480)
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


def score_at(results, gt, th, left_pupils, right_pupils):
    """Greedy IoU-0.5 matching of detections with score >= th."""
    tp = fp = 0
    total = sum(len(b) for b, _ in gt)
    errs = []
    for res, (boxes, lms) in zip(results, gt):
        order = np.argsort(-np.asarray(res.scores))
        used = set()
        for j in order:
            if res.scores[j] < th:
                continue
            bb = tuple(int(v) for v in res.bboxes[j])
            best, bi = 0.0, -1
            for i, b in enumerate(boxes):
                if i in used:
                    continue
                v = iou(bb, b)
                if v > best:
                    best, bi = v, i
            if best >= 0.5:
                tp += 1
                used.add(bi)
                # inter-pupil-normalized alignment error (common.cpp:41-77)
                pred = np.asarray(res.shapes[j], np.float64)
                gtl = lms[bi]
                lp = np.stack(
                    [gtl[0::2][list(left_pupils)], gtl[1::2][list(left_pupils)]]
                ).mean(axis=1)
                rp = np.stack(
                    [gtl[0::2][list(right_pupils)], gtl[1::2][list(right_pupils)]]
                ).mean(axis=1)
                ipd = float(np.hypot(*(lp - rp)))
                d = np.hypot(pred[0::2] - gtl[0::2], pred[1::2] - gtl[1::2])
                errs.append(float(d.mean() / max(ipd, 1e-9)))
            else:
                fp += 1
    return {
        "th": float(th),
        "tp": tp,
        "fp": fp,
        "faces": total,
        "recall": tp / max(total, 1),
        "fp_per_scene": fp / max(len(results), 1),
        "mean_align_error": float(np.mean(errs)) if errs else None,
    }


def sweep(results, gt):
    """The sweep's points over `results` of the scenes `gt`."""
    from scripts.train_flagship_torch import flagship_config

    c = flagship_config()
    return [score_at(results, gt, th, c.left_pupils, c.right_pupils) for th in SWEEP]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="models/flagship_synth.model")
    ap.add_argument("out", nargs="?", default="models/scene_eval_torch.json")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; without one this raises)",
    )
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == os.path.abspath(JAX_RECORD):
        raise ValueError(f"{args.out} is the JAX package's record; write elsewhere")
    from jda_tpu_torch import Detector, load_model

    # ladder density is a detector parameter (the reference's
    # fddb_scale_factor, model/config.json: 1.2); the default 1.25 ladder
    # puts every face's best window within [1/sqrt(1.25), sqrt(1.25)] =
    # [0.894, 1.118] of its true scale, inside the widened training band
    # ([0.87, 1.2], train_flagship_torch.make_face)
    ladder_scale = float(os.environ.get("JDA_TPU_EVAL_SCALE", "1.25"))
    m = load_model(args.model)
    det = Detector(m, rounding=True, device=args.device)

    scenes, gt = build_scenes(np.random.default_rng(123), N_SCENES)
    t0 = time.perf_counter()
    results = det.detect_stream(scenes, batch=8, th=SWEEP[0], scale=ladder_scale)
    secs = time.perf_counter() - t0
    pts = sweep(results, gt)
    payload = {
        "model": args.model,
        "scenes": N_SCENES,
        "faces": pts[0]["faces"],
        "ladder_scale": ladder_scale,
        "sweep": pts,
    }
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    for p in pts:
        err = f"{p['mean_align_error']:.4f}" if p["mean_align_error"] else "-"
        print(
            f"th={p['th']:+.2f}  recall={p['recall']:.3f} "
            f"({p['tp']}/{p['faces']})  fp/scene={p['fp_per_scene']:.2f}  "
            f"align-err={err}"
        )
    print(f"{N_SCENES} scenes on {det.device} in {secs:.2f} s "
          f"({N_SCENES / secs:.2f} img/s, plans built in the run)")
    print(f"wrote {args.out}")
    return payload


if __name__ == "__main__":
    main()
