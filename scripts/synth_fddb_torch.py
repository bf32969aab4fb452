"""FDDB-harness end-to-end run on synthetic scenes, on the port (the
counterpart of scripts/synth_fddb.py).

Composes the synthetic scenes of scripts/eval_synth_scenes_torch.py into
FDDB's directory layout:

    <dir>/images/synth/fold_FF/img_NNN.jpg
    <dir>/FDDB-folds/FDDB-fold-FF.txt
    <dir>/FDDB-folds/FDDB-fold-FF-ellipseList.txt

written as JPEG by `jda_tpu_torch.jpeg.encode_gray` (OpenCV's bytes), then
runs `jda_tpu_torch.fddb.run_fddb` with detection method 1 (batched on the
card), reading the images with `jpeg.imread_gray`, and scores a
discROC-style sweep (TP at IoU 0.5 against total FP) from the fold outputs
against the ellipse lists.  No OpenCV is needed.

Usage:
  python scripts/synth_fddb_torch.py models/flagship_synth.model \
      [--dir data/fddb_synth] [--folds 2] [--scenes 24] [--device cpu]
      [--result-dir DIR] [--out-json models/fddb_synth_torch_stats.json]

An existing tree is reused.  The fold outputs go to <dir>/result_torch
unless --result-dir names another place, so data/fddb_synth/result, the
JAX package's record, is not overwritten; the stats JSON never replaces
models/fddb_synth_stats.json.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

JAX_RECORD = os.path.join(ROOT, "models", "fddb_synth_stats.json")
SCORE_TOL = 2e-4  # fold-out scores against the JAX package's (the repo's gate)


def build_tree(root: str, folds: int, scenes_per_fold: int, seed: int = 123):
    """Write the tree; returns the seconds spent generating the scenes and
    encoding them."""
    from jda_tpu_torch.jpeg import encode_gray
    from scripts.eval_synth_scenes_torch import build_scenes

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "FDDB-folds"), exist_ok=True)
    t_gen = t_enc = 0.0
    for f in range(1, folds + 1):
        t0 = time.perf_counter()
        scenes, gt = build_scenes(rng, scenes_per_fold)
        t_gen += time.perf_counter() - t0
        img_dir = os.path.join(root, "images", "synth", f"fold_{f:02d}")
        os.makedirs(img_dir, exist_ok=True)
        names, ell_lines = [], []
        for i, (scene, (boxes, _lms)) in enumerate(zip(scenes, gt)):
            name = f"synth/fold_{f:02d}/img_{i:03d}"
            t0 = time.perf_counter()
            data = encode_gray(scene)
            t_enc += time.perf_counter() - t0
            with open(os.path.join(root, "images", name + ".jpg"), "wb") as fh:
                fh.write(data)
            names.append(name)
            ell_lines.append(name)
            ell_lines.append(str(len(boxes)))
            for (x0, y0, size) in boxes:
                # FDDB ellipse: major minor angle cx cy score — a square
                # face box becomes a circle of radius size/2
                r = size / 2.0
                ell_lines.append(
                    f"{r:.6f} {r:.6f} 0.000000 {x0 + r:.6f} {y0 + r:.6f}  1"
                )
        with open(
            os.path.join(root, "FDDB-folds", f"FDDB-fold-{f:02d}.txt"), "w"
        ) as fh:
            fh.write("\n".join(names) + "\n")
        with open(
            os.path.join(
                root, "FDDB-folds", f"FDDB-fold-{f:02d}-ellipseList.txt"
            ),
            "w",
        ) as fh:
            fh.write("\n".join(ell_lines) + "\n")
    return t_gen, t_enc


def score_outputs(root: str, folds: int, result_dir=None):
    """discROC points from fold-FF-out.txt vs the ellipse lists: detections
    (score-desc) greedily matched to GT circles at IoU >= 0.5 of the
    bounding boxes.  `result_dir` defaults to <root>/result, where the JAX
    script's harness writes."""
    from jda_tpu_torch.fddb import read_ellipses
    from scripts.eval_synth_scenes_torch import iou

    result_dir = result_dir or os.path.join(root, "result")
    dets = []  # (score, is_tp)
    total_faces = 0
    for f in range(1, folds + 1):
        gt = read_ellipses(root, f)
        total_faces += sum(len(v) for v in gt.values())
        path = os.path.join(result_dir, f"fold-{f:02d}-out.txt")
        with open(path) as fh:
            toks = fh.read().split("\n")
        i = 0
        while i < len(toks):
            name = toks[i].strip()
            if not name:
                i += 1
                continue
            n = int(toks[i + 1])
            boxes = gt.get(name, np.zeros((0, 6)))
            gt_boxes = [
                (e[3] - e[0], e[4] - e[1], 2 * e[0]) for e in boxes
            ]  # (x0, y0, w): x from the major half-axis, y from the minor
            # (FDDB ellipse rows are (major, minor, angle, cx, cy, 1);
            # equal for the synthetic circles, distinct on real lists)
            rows = [
                [float(v) for v in toks[i + 2 + j].split()] for j in range(n)
            ]
            rows.sort(key=lambda r: -r[4])
            used = set()
            for x, y, w, h, s in rows:
                best, bi = 0.0, -1
                for ind, b in enumerate(gt_boxes):
                    if ind in used:
                        continue
                    v = iou((x, y, w), b)
                    if v > best:
                        best, bi = v, ind
                if best >= 0.5:
                    used.add(bi)
                    dets.append((s, 1))
                else:
                    dets.append((s, 0))
            i += 2 + n
    dets.sort(key=lambda t: -t[0])
    roc = []
    tp = fp = 0
    for s, is_tp in dets:
        tp += is_tp
        fp += 1 - is_tp
        roc.append((fp, tp / max(total_faces, 1), s))
    return total_faces, roc


def disc_roc_points(roc, scenes):
    """Headline discROC points: best recall at FP budgets 0, scenes/4,
    scenes and 4 * scenes."""
    pts = {}
    for fp_budget in (0, scenes // 4, scenes, 4 * scenes):
        best = 0.0
        for fp, rec, s in roc:
            if fp <= fp_budget:
                best = max(best, rec)
        pts[f"recall@fp<={fp_budget}"] = round(best, 4)
    return pts


def compare_fold_out(got_path, want_path, tol=SCORE_TOL):
    """A fold output against another: its lines paired in order, image
    names and counts compared as text, rects exactly and scores within
    `tol`.  Returns the counts: lines, detections, lines that differ
    otherwise (names, counts, rects, or a line count), scores outside tol,
    scores printed differently, and the largest score difference."""
    with open(got_path) as fh:
        got = fh.read().splitlines()
    with open(want_path) as fh:
        want = fh.read().splitlines()
    out = dict(lines=len(got), detections=0, differ=abs(len(got) - len(want)),
               scores_outside=0, printed_differently=0, largest_difference=0.0)
    for a, b in zip(got, want):
        ta, tb = a.split(), b.split()
        if len(ta) != 5 or len(tb) != 5 or ta[:4] != tb[:4]:
            out["differ"] += a != b
            continue
        d = abs(float(ta[4]) - float(tb[4]))
        out["detections"] += 1
        out["scores_outside"] += not d <= tol
        out["printed_differently"] += ta[4] != tb[4]
        out["largest_difference"] = max(out["largest_difference"], d)
    return out


def compare_run(root, result_dir, folds, against, against_json=None, payload=None):
    """This run against another run's tree `against` (its FDDB-folds and
    result/) and stats JSON: the fold and ellipse lists byte for byte, the
    fold outputs by `compare_fold_out`, and the counts and discROC points.
    Returns (report, number of mismatches)."""
    report, bad = {"lists_differ": [], "fold_out": {}}, 0
    for f in range(1, folds + 1):
        for name in (f"FDDB-fold-{f:02d}.txt", f"FDDB-fold-{f:02d}-ellipseList.txt"):
            with open(os.path.join(root, "FDDB-folds", name), "rb") as a, \
                    open(os.path.join(against, "FDDB-folds", name), "rb") as b:
                if a.read() != b.read():
                    report["lists_differ"].append(name)
        r = compare_fold_out(os.path.join(result_dir, f"fold-{f:02d}-out.txt"),
                             os.path.join(against, "result", f"fold-{f:02d}-out.txt"))
        report["fold_out"][f] = r
        bad += r["differ"] + r["scores_outside"]
    bad += len(report["lists_differ"])
    if against_json and payload:
        with open(against_json) as fh:
            ref = json.load(fh)
        fields = {"faces": (payload["faces"], ref["faces"]),
                  "disc_roc_points": (payload["disc_roc_points"], ref["disc_roc_points"])}
        for k in ("images", "windows", "face_windows", "average_cart_n"):
            fields[k] = (payload["harness"][k], ref["harness"][k])
        report["fields_differ"] = {k: v for k, v in fields.items() if v[0] != v[1]}
        bad += len(report["fields_differ"])
    return report, bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("model", nargs="?", default="models/flagship_synth.model")
    ap.add_argument("--dir", default="data/fddb_synth")
    ap.add_argument("--folds", type=int, default=2)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--out-json", default="models/fddb_synth_torch_stats.json")
    ap.add_argument("--result-dir", default=None,
                    help="where the fold outputs go (default <dir>/result_torch)")
    ap.add_argument("--against", default=None,
                    help="another run's tree (FDDB-folds/, result/) to hold this run "
                         "against; mismatches are counted and make the exit non-zero")
    ap.add_argument("--against-json", default=None,
                    help="that run's stats JSON (counts and discROC points compared)")
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; without one this raises)",
    )
    args = ap.parse_args(argv)
    if os.path.abspath(args.out_json) == os.path.abspath(JAX_RECORD):
        raise ValueError(f"{args.out_json} is the JAX package's record; write elsewhere")
    from jda_tpu_torch import load_model
    from jda_tpu_torch.fddb import run_fddb
    from jda_tpu_torch.jpeg import imread_gray
    from jda_tpu_torch.utils import resolve_device
    from scripts.train_flagship_torch import flagship_config

    device = resolve_device(args.device)  # raises before any work without CUDA
    result_dir = args.result_dir or os.path.join(args.dir, "result_torch")
    t_gen = t_enc = 0.0
    if not os.path.exists(os.path.join(args.dir, "FDDB-folds", "FDDB-fold-01.txt")):
        t_gen, t_enc = build_tree(args.dir, args.folds, args.scenes)

    decoded = {"images": 0, "seconds": 0.0}

    def timed_imread(path):
        t0 = time.perf_counter()
        img = imread_gray(path)
        decoded["seconds"] += time.perf_counter() - t0
        decoded["images"] += img is not None
        return img

    m = load_model(args.model)
    c = dataclasses.replace(
        flagship_config(),
        fddb_dir=args.dir,
        fddb_detect_method=1,
        fddb_minimum_size=40,
        fddb_scale_factor=1.25,
        fddb_step=5,
        fddb_nms=True,
        fddb_result=False,
    )
    stats = run_fddb(m, c, folds=list(range(1, args.folds + 1)), out_dir=result_dir,
                     imread=timed_imread, device=device)
    # fold 1 pays the plan's construction; report warm throughput separately
    warm = [f for f in stats["folds"] if f["fold"] > 1]
    if warm:
        stats["warm_images_per_sec"] = round(
            sum(f["images"] for f in warm) / sum(f["seconds"] for f in warm),
            2,
        )

    faces, roc = score_outputs(args.dir, args.folds, result_dir)
    pts = disc_roc_points(roc, args.scenes)
    payload = {
        "model": args.model,
        "dir": args.dir,
        "faces": faces,
        "harness": stats,
        "disc_roc_points": pts,
        "roc_tail": roc[-1] if roc else None,
        "device": str(device),
        "host_seconds": {"generate": t_gen, "encode": t_enc,
                         "decode": decoded["seconds"], "detect": stats["seconds"]},
    }
    bad = 0
    if args.against:
        payload["against"], bad = compare_run(args.dir, result_dir, args.folds, args.against,
                                              args.against_json, payload)
        payload["against"]["mismatches"] = bad
    with open(args.out_json, "w") as fh:
        json.dump(payload, fh, indent=1)
    print(json.dumps({"faces": faces, **pts, "img_per_sec": round(stats["images_per_sec"], 2),
                      "host_seconds": payload["host_seconds"]}))
    if args.against:
        print(json.dumps(payload["against"]))
        if bad:
            raise SystemExit(f"{bad} mismatches against {args.against}")
    return payload


if __name__ == "__main__":
    main()
