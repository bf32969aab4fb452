"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--control-seeds 7,8,9]

For each of --seeds: the cell's pool from that seed, one pass of the
cell's call over it on the program (the timed path at the timed sizes),
every answer compared with the reference: the lower readings.  For each of
--control-seeds: the reference computed in bfloat16, the precision below
the configuration's float32, put in the program's place and compared the
same way: the upper readings.  Prints one JSON line per seed and a summary
line with the largest program reading and the smallest control reading of
each number.  Needs a CUDA card, as run.py does.
"""

import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    import argparse

    import torch

    from benchmark import harness as H

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    c = H.resolve(H.load_spec(), args.workload)
    config, traffic = c["config"], c["traffic"]
    fields = H.model_fields(config)
    calls = H.batches(traffic)
    program = H.Program(config, traffic, fields, "cuda") if args.seeds else None
    lower, upper = {}, {}
    for kind, todo in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in todo:
            t0 = time.perf_counter()
            pool = H.make_pool(traffic, seed)
            want, per, _ = H.reference(config, traffic, fields, pool, "cuda")
            sums = [sum(per[j]["visits"] for j in idx) for idx in calls]
            if kind == "program":
                served, visits = [], []
                for idx in calls:
                    served.extend(program.call(list(pool[idx])))
                    visits.append(program.visits())
                has = visits[0] is not None
                nums = H.compare(served, want, visits if has else None, sums if has else None)
            else:
                got, per_b, _ = H.reference(config, traffic, fields, pool, "cuda",
                                            dtype=torch.bfloat16)
                has = config["entry"] == "c_api"
                nums = H.compare(got, want,
                                 [sum(per_b[j]["visits"] for j in idx) for idx in calls] if has else None,
                                 sums if has else None)
            box_n = sum(len(a[0]) for a in want)
            print(json.dumps(dict(kind=kind, workload=args.workload, seed=seed, boxes=box_n,
                                  seconds=round(time.perf_counter() - t0, 3), **nums)), flush=True)
            acc = lower if kind == "program" else upper
            for k, v in nums.items():
                if k not in H.CHECKS:
                    continue
                acc[k] = max(acc.get(k, v), v) if kind == "program" else min(acc.get(k, v), v)
    print(json.dumps(dict(summary=args.workload, program_max=lower, control_min=upper,
                          card=torch.cuda.get_device_name(0))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
