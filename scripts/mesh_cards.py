#!/usr/bin/env python3
"""The multi-device paths over NCCL on several cards, against one card.

    python3 scripts/mesh_cards.py --ranks 4          # four cards, NCCL
    python3 scripts/mesh_cards.py --ranks 4 --device cpu --faces 256 \
        --hw 120,160                                  # a small rehearsal, gloo

1. Training at chip_smoke.py's flagship geometry (K=540, 27 landmarks,
   F=2,000, carts 532..539 from `empty_model`, mining, the regression) on
   `--faces` faces of `chip_smoke.train_corpus`: the Trainer on one device
   in this process, then `Trainer(mesh=)` at `--ranks` ranks.  Every model
   field must be equal, W included, and the live masks and the generator's
   next draw; printed: seconds per cart and per node of both, and the
   ranks' collectives (all-reduces, bytes and seconds per node, their
   share of a node's time, the largest exact sum).
2. `detect_batch(mesh=)` of the bench model (T=5, K=540, seed 7, realistic
   drop profile) on 4 * ranks + 1 images of `--hw`: every rank equal to the
   batch without a mesh; `dense0_filter` launches per rank on the card.
3. `dryrun_multichip(ranks)`.

Prints the card (nvidia-smi name and power limit) and, last, one JSON line
of the numbers.  Without CUDA it needs `--device cpu`.
"""

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu for a gloo rehearsal")
    ap.add_argument("--faces", type=int, default=16384)
    ap.add_argument("--hw", default="480,640", help="image height,width")
    args = ap.parse_args()

    import torch

    import chip_smoke as CS
    import jda_tpu_torch as jt
    from jda_tpu_torch.entry import dryrun_multichip, run_each, run_on_mesh
    from jda_tpu_torch.train.boost import empty_model
    from jda_tpu_torch.train.dryrun import detect_on_mesh, train_on_mesh
    from jda_tpu_torch.utils import resolve_device

    dev = resolve_device(args.device)
    n = args.ranks
    card = "cpu"
    if dev.type == "cpu":
        # each rank runs one thread (entry.MeshRun), and the CPU's Cholesky
        # rounds by its thread count: W is equal only at equal counts
        torch.set_num_threads(1)
    else:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True,
        ).stdout.strip().splitlines()[0]
        from jda_tpu_torch.ops import _build

        _build.build_all(["dense0", "dense0_image"])
    out = {"ranks": n, "device": dev.type, "card": card, "faces": args.faces}

    # -- 1. training: one device, then the mesh ------------------------------------
    c = jt.Config(**CS.FLAGSHIP_T1)
    bgs = [CS.make_image(480, 640, seed=500 + i) for i in range(12)]
    rows, gts = CS.train_corpus(args.faces, c, seed=2)
    start = empty_model(c)
    start.cart_idx = CS.FIRST_CART - 1
    train = functools.partial(train_on_mesh, model=start, mining_max_batches=2000,
                              mining_batch=2048)
    one = train(None, c, rows, gts, bgs, device=dev)
    t0 = time.perf_counter()
    ranks = run_on_mesh(train, n, c, rows, gts, bgs, device=args.device, limit=1500)
    mesh_s = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        CS.same_state(res, one, f"rank {r} of {n} against one device")
    nodes = ranks[0]["stats"]["nodes"]
    col = ranks[0]["collectives"]
    split = [col["classification"], col["regression"]]
    per_node = {k: sum(x[k] for x in split) / len(nodes) for k in ("collectives", "bytes", "seconds")}

    def cart_s(res):
        return statistics.median(x["seconds"] for x in res["stats"]["carts"])

    out["train"] = {
        "one_device_s": one["seconds"], "mesh_s": [r["seconds"] for r in ranks],
        "spawn_and_run_s": mesh_s,
        "cart_s_one": cart_s(one), "cart_s_mesh": [cart_s(r) for r in ranks],
        "node_ms_one": 1e3 * statistics.median(one["stats"]["nodes"]),
        "node_ms_mesh": 1e3 * statistics.median(nodes),
        "allreduces_per_node": per_node["collectives"], "bytes_per_node": per_node["bytes"],
        "collective_ms_per_node": 1e3 * per_node["seconds"],
        "collective_share": per_node["seconds"] * len(nodes) / sum(nodes),
        "collectives": col, "max_abs_sum": ranks[0]["max_abs_sum"],
    }
    print(f"[1] {card}: training, {args.faces} faces, {n} ranks: every rank equal to one "
          f"device in every field, W included; {json.dumps(out['train'])}", flush=True)

    # -- 2. detection ---------------------------------------------------------------
    h, w = (int(v) for v in args.hw.split(","))
    model = jt.synthetic_model(T=5, K=540, landmark_n=27, seed=7,
                               drop_profile=jt.realistic_drop_profile(5, 540))
    imgs = [CS.make_image(h, w, seed=3 + i) for i in range(4 * n + 1)]
    want = jt.Detector(model, device=dev).detect_batch(imgs, **CS.BENCH_KW)
    det = run_on_mesh(run_each, n, [(functools.partial(detect_on_mesh, **CS.BENCH_KW),
                                     (model, imgs))], device=args.device, limit=900)
    for r, (res,) in enumerate(det):
        for i, (x, y) in enumerate(zip(res["results"], want)):
            CS.same_result(x, y, f"rank {r} of {n}, image {i}: differs from no mesh")
    out["detect"] = {"images": len(imgs), "launches": [res["launches"] for (res,) in det],
                     "boxes": [r.n for r in want]}
    if dev.type == "cuda" and any(la != (2, 0) for la in out["detect"]["launches"]):
        raise AssertionError(f"detect_batch(mesh=): launches {out['detect']['launches']}")
    print(f"[2] detect_batch(mesh=), {len(imgs)} images of {h}x{w}, {n} ranks: every rank "
          f"equal to no mesh; launches (dense0_filter, dense0_image) per rank "
          f"{out['detect']['launches']}", flush=True)

    # -- 3. the dry run ---------------------------------------------------------------
    t0 = time.perf_counter()
    dryrun_multichip(n, device=args.device)
    out["dryrun_s"] = time.perf_counter() - t0
    print(f"[3] dryrun_multichip({n}) in {out['dryrun_s']:.1f} s", flush=True)
    print(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
