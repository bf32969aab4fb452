"""Command-line interface mirroring the reference CLI (src/main.cpp:25-51):

    python -m jda_tpu_torch [--config config.json] [--device cuda] \
        <train|resume|test|fddb|dump|live|detect> [args...]

The JAX package's CLI with the same commands, options and JSON config
schema (config.template.json).  `--device` names the device the trainer
and detectors run on: CUDA by default (without a card the commands raise),
`--device cpu` runs the plain PyTorch path.  Reading and writing image
files (train's positives and backgrounds, test, dump, live, detect) needs
OpenCV.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from jda_tpu_torch.config import Config
from jda_tpu_torch.params import load_model, save_model
from jda_tpu_torch.utils import log, require_cv2


def _load_config(path: str) -> Config:
    if path and os.path.exists(path):
        return Config.from_json(path)
    log(f"config {path!r} not found, using defaults")
    return Config()


def _finish_training(tr, c: Config, args) -> int:
    tr.train()
    tr.model.stage_idx, tr.model.cart_idx = c.T, -1
    save_model(tr.model, args.model, dtype="double")
    log(f"model saved to {args.model}")
    return 0


def cmd_train(c: Config, args) -> int:
    """src/train.cpp:15-51."""
    from jda_tpu_torch.data import DataSet
    from jda_tpu_torch.train.boost import Trainer

    tr = Trainer(c, device=args.device)
    tr.snapshot_dir = args.snapshot_dir
    cache = args.data_cache
    if cache and os.path.exists(cache):
        log(f"resume corpus from {cache}")
        DataSet.resume(cache, tr.pos, tr.neg)
        tr.neg_gen.load(c.bg_txts, tr.rng)
        tr.model.mean_shape = tr.pos.mean_shape.copy()
    else:
        tr.load_data()
        if cache:
            DataSet.snapshot(tr.pos, tr.neg, cache)
    return _finish_training(tr, c, args)


def cmd_resume(c: Config, args) -> int:
    """src/train.cpp:54-79: reload model + corpus snapshots, re-enter the
    stage/cart loop at the persisted cursor."""
    from jda_tpu_torch.data import DataSet
    from jda_tpu_torch.train.boost import Trainer

    tr = Trainer(c, model=load_model(c.resume_model or args.model), device=args.device)
    tr.snapshot_dir = args.snapshot_dir
    DataSet.resume(c.resume_data or args.data_cache, tr.pos, tr.neg)
    tr.neg_gen.load(c.bg_txts, tr.rng)
    return _finish_training(tr, c, args)


def cmd_test(c: Config, args) -> int:
    """src/test.cpp:15-68: detect over test.txt, draw, save images."""
    cv2 = require_cv2("jda_tpu_torch test reads and writes image files")
    from jda_tpu_torch.cascador import CppDetector

    det = CppDetector(load_model(args.model), c, device=args.device)
    out_dir = args.out or "./test_result"
    os.makedirs(out_dir, exist_ok=True)
    with open(c.test_txt) as f:
        paths = [ln.strip() for ln in f if ln.strip()]
    for i, path in enumerate(paths):
        img = cv2.imread(path)
        if img is None:
            log(f"Can not open {path}, Skip it")
            continue
        gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        rects, scores, shapes, _ = det.detect(gray)
        log(f"{path}: {len(rects)} faces")
        for r, sh in zip(rects, shapes):
            cv2.rectangle(img, (r[0], r[1]), (r[0] + r[2], r[1] + r[3]), (0, 0, 255), 2)
            for k in range(len(sh) // 2):
                cv2.circle(img, (int(sh[2 * k]), int(sh[2 * k + 1])), 2, (0, 255, 0), -1)
        cv2.imwrite(os.path.join(out_dir, f"{i:06d}.jpg"), img)
    return 0


def cmd_fddb(c: Config, args) -> int:
    from jda_tpu_torch.fddb import run_fddb

    stats = run_fddb(
        load_model(args.model),
        c,
        folds=[int(x) for x in args.folds.split(",")] if args.folds else None,
        annotate=c.fddb_result,
        device=args.device,
    )
    log(f"fddb done: {stats['images_per_sec']:.2f} images/sec")
    return 0


def cmd_dump(c: Config, args) -> int:
    """src/train.cpp:81-90 + data.cpp:466-477: dump training patches with
    current shapes drawn, both datasets (train.cpp:88-89)."""
    cv2 = require_cv2("jda_tpu_torch dump reads and writes image files")
    from jda_tpu_torch.data import DataSet

    pos, neg = DataSet(c, True), DataSet(c, False)
    DataSet.resume(args.data_cache, pos, neg)
    out = args.out or "./dump"
    so = c.img_o_size
    for name, ds in (("pos", pos), ("neg", neg)):
        sub = os.path.join(out, name)
        os.makedirs(sub, exist_ok=True)
        for i in range(len(ds.imgs)):
            img = cv2.cvtColor(ds.imgs[i, : so * so].reshape(so, so).copy(), cv2.COLOR_GRAY2BGR)
            sh = ds.current_shapes[i] * so
            for k in range(c.landmark_n):
                cv2.circle(img, (int(sh[2 * k]), int(sh[2 * k + 1])), 1, (0, 255, 0), -1)
            cv2.imwrite(os.path.join(sub, f"{i:06d}.jpg"), img)
        log(f"dumped {len(ds.imgs)} {name} patches to {sub}")
    return 0


def cmd_live(c: Config, args) -> int:
    """src/live.cpp:11-52: camera/video stream -> detect -> draw -> show."""
    cv2 = require_cv2("jda_tpu_torch live reads and writes image files")
    from jda_tpu_torch.cascador import CppDetector

    det = CppDetector(load_model(args.model), c, device=args.device)
    cap = cv2.VideoCapture(args.video if args.video else 0)
    if not cap.isOpened():
        log("can not open video source")
        return 1
    show = os.environ.get("DISPLAY") and not args.no_show
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            t0 = time.perf_counter()
            rects, _, _, _ = det.detect(gray)
            fps = 1.0 / max(time.perf_counter() - t0, 1e-9)
            log(f"{len(rects)} faces, fps = {fps:.2f}")
            for r in rects:
                cv2.rectangle(frame, (r[0], r[1]), (r[0] + r[2], r[1] + r[3]), (0, 0, 255), 2)
            if show:
                cv2.imshow("jda_tpu_torch live", frame)
                if cv2.waitKey(30) == 27:
                    break
    finally:
        cap.release()
    return 0


def cmd_detect(c: Config, args) -> int:
    """C-API-style single image detection (c/jda.h:62-63)."""
    cv2 = require_cv2("jda_tpu_torch detect reads and writes image files")
    from jda_tpu_torch.detect import Detector

    img = cv2.imread(args.image, cv2.IMREAD_GRAYSCALE)
    if img is None:
        log(f"can not open {args.image}")
        return 1
    det = Detector(load_model(args.model), device=args.device)
    res = det.detect(
        img,
        scale=args.scale,
        min_size=args.min_size,
        max_size=args.max_size,
        th=args.th,
    )
    for b, s in zip(res.bboxes, res.scores):
        print(f"{b[0]} {b[1]} {b[2]} {s:.6f}")
    log(f"{res.n} faces")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="jda_tpu_torch")
    p.add_argument("--config", default="./config.json")
    p.add_argument(
        "--device", default=None, help="torch device (default: cuda, which must exist)"
    )
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--model", default="./jda.model")
        sp.add_argument("--data-cache", default="./jda_train_data.data")
        sp.add_argument("--snapshot-dir", default="./snapshots")
        sp.add_argument("--out", default=None)
        # also accepted after the command
        sp.add_argument("--device", default=argparse.SUPPRESS)

    for name in ("train", "resume", "test", "fddb", "dump"):
        sp = sub.add_parser(name)
        common(sp)
        if name == "fddb":
            sp.add_argument("--folds", default=None)
    sp = sub.add_parser("live")
    common(sp)
    sp.add_argument("--video", default=None)
    sp.add_argument("--no-show", action="store_true")
    sp = sub.add_parser("detect")
    common(sp)
    sp.add_argument("image")
    sp.add_argument("--scale", type=float, default=1.25)
    sp.add_argument("--min-size", type=int, default=24)
    sp.add_argument("--max-size", type=int, default=-1)
    sp.add_argument("--th", type=float, default=-0.5)

    args = p.parse_args(argv)
    c = _load_config(args.config)
    return {
        "train": cmd_train,
        "resume": cmd_resume,
        "test": cmd_test,
        "fddb": cmd_fddb,
        "dump": cmd_dump,
        "live": cmd_live,
        "detect": cmd_detect,
    }[args.command](c, args)


if __name__ == "__main__":
    sys.exit(main())
