"""One run of one benchmark cell.

Everything that belongs to a configuration, a traffic mix, a cell's limits
or a metric sits in files of its own, found by the names in BENCHMARK.json:

  * configuration `<c>`: the file its entry names (benchmark/configs/<c>.json);
  * traffic mix `<t>`: benchmark/traffic/<t>.json, parameters read by
    `make_pool` and `calls`;
  * the limits of cell `<w>`: benchmark/limits/<w>.json;
  * metric `<m>`: benchmark/metrics/<m>.py, whose `read(r)` takes the
    run's readings (`Readings`) and returns a number, or None where it finds
    nothing to read.

A configuration file states its sizes (`T`, `K`, `landmark_n`,
`tree_depth`), its `entry` (`c_api` with a `detect` block, or `cpp` with an
`fddb` block) and three keys that let a new configuration bring its own
code as new files, each a path from the checkout's root:

  * `model`: where the cascade's arrays come from.  `{"kind": "synthetic",
    "seed", "cart_th_file"}` is frozen.synthetic_model; `{"kind": "file",
    "path", "sha256"}` a model file in the reference's format, refused
    unless its sha256 is the one stated; `{"kind": "module", "path", ...}` a
    module whose `fields(config, root)` returns the arrays (frozen.FIELDS
    plus `T`, `K`, `landmark_n`, `tree_depth`) and reads the block's other
    keys (a seed, say) itself.  The arrays of a file or a module must hold
    exactly those fields, at the configuration's sizes;
  * `reference` (optional): a module that decides `correct` in place of
    benchmark/reference.py.  It exports `answers(config, traffic, fields,
    pool, device, dtype=None)`, returning (answers, one per pool image as
    `Program.call` returns them; per, a dict per pool image with at least
    `windows` and `visits`; the window ladder), and may export
    `counted_ops(per_image, config)`, the operations an image needs, which
    the traced run sums for `Readings.traced_ops`.  The dense filter's
    bound (`Readings.dense0_bound_s`) is summed only where `per` carries
    `visits0` and `alive0`;
  * `detector` (optional, `c_api` only): options of the program's
    `Detector` that the reference follows too; `{"rounding": true}` rounds
    feature coordinates half away from zero (the C++ semantics) on both
    sides.  Absent, coordinates are truncated, as the C API does.

`resolve` refuses a reference or model module whose imports (its own and
those of the benchmark modules it imports, read with `ast`) name the
program, JAX or the JAX package, and an unknown `detector` key.

A run makes its inputs from the seed, builds the program's detector, warms
up the cell's own shapes, drives the entry point in a closed loop for the
window, then checks every answer it served against the reference and
prints one JSON line.
"""

from __future__ import annotations

import ast
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from benchmark import frozen as F
from benchmark import reference as R
from benchmark import yardstick as Y

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "jda_tpu")
# what a reference or model module may not import: JAX's, and the program
REFEREE_FORBIDDEN = FORBIDDEN + ("jda_tpu_torch",)
DETECTOR_OPTIONS = {"rounding": bool}  # the `detector` keys, with their types
SIZES = ("T", "K", "landmark_n", "tree_depth")
IMAGES_PER_SEED = 4096  # pool image i of seed s is drawn from s * 4096 + i


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------

def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(spec: dict, workload: str, root: str = ROOT) -> dict:
    """The cell named `workload` with its configuration, traffic, limits and
    the metrics it reports.  Raises KeyError for an unknown name."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if cell["config"] not in configs:
        raise KeyError(f"unknown config {cell['config']!r}")

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    config = _json(os.path.join(root, configs[cell["config"]]["file"]))
    check_config(config, root)
    return dict(
        cell=cell,
        config=config,
        traffic=_json(os.path.join(BENCH, "traffic", cell["traffic"] + ".json")),
        limits=_json(os.path.join(BENCH, "limits", workload + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)],
    )


def check_config(config: dict, root: str = ROOT) -> None:
    """Refuse a configuration whose `detector` block has an unknown key, a
    value of another type or another entry than `c_api`, or whose reference
    or model module imports the program or JAX (`imported_names`)."""
    opts = config.get("detector", {})
    if opts and config["entry"] != "c_api":
        raise ValueError(f"`detector` options are for the c_api entry, not {config['entry']!r}")
    for k, v in opts.items():
        if k not in DETECTOR_OPTIONS:
            raise ValueError(f"unknown detector option {k!r}; known: {sorted(DETECTOR_OPTIONS)}")
        if not isinstance(v, DETECTOR_OPTIONS[k]):
            raise ValueError(f"detector option {k!r} takes a {DETECTOR_OPTIONS[k].__name__}")
    paths = [config["reference"]] if "reference" in config else []
    if config["model"]["kind"] == "module":
        paths.append(config["model"]["path"])
    for path in paths:
        bad = imported_names(os.path.join(root, path)) & set(REFEREE_FORBIDDEN)
        if bad:
            raise ValueError(f"{path} imports {sorted(bad)}: a reference or model module "
                             "may import neither the program nor JAX")


def imported_names(path: str, _seen=None) -> set:
    """Top-level names of the modules that the source at `path` imports,
    anywhere in it (statements, `__import__("x")`, `import_module("x")`),
    and those of the benchmark's own modules it imports, followed through."""
    seen = set() if _seen is None else _seen
    seen.add(os.path.abspath(path))
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    names, local = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods = [node.module] + [f"{node.module}.{a.name}" for a in node.names]
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "id", getattr(node.func, "attr", None))
              in ("__import__", "import_module")):
            mods = [node.args[0].value]
        else:
            continue
        for mod in mods:
            parts = mod.split(".")
            names.add(parts[0])
            if parts[0] == "benchmark" and len(parts) > 1:
                local.append(os.path.join(BENCH, *parts[1:]) + ".py")
    for p in local:
        if os.path.exists(p) and os.path.abspath(p) not in seen:
            names |= imported_names(p, seen)
    return names


def _load(path: str, prefix: str):
    """The module at `path`, executed afresh under a name of its own."""
    name = prefix + os.path.splitext(os.path.basename(path))[0].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_module(config: dict, root: str = ROOT):
    """The module that decides `correct` for the configuration: its
    `reference` file, or benchmark/reference.py."""
    if "reference" not in config:
        return R
    return _load(os.path.join(root, config["reference"]), "benchmark_reference_")


def metric_reader(name: str):
    """`read` of benchmark/metrics/<name>.py.  Raises KeyError for an
    unknown name."""
    path = os.path.join(BENCH, "metrics", name + ".py")
    if not os.path.exists(path):
        raise KeyError(f"no reader for metric {name!r} ({path})")
    return _load(path, "benchmark_metric_").read


# ---------------------------------------------------------------------------
# the work: model, inputs, program
# ---------------------------------------------------------------------------

def model_fields(config: dict, root: str = ROOT) -> dict:
    """The configuration's model arrays (frozen generator, model file or
    module)."""
    m = config["model"]
    if m["kind"] == "synthetic":
        th = np.load(os.path.join(root, m["cart_th_file"])) if m.get("cart_th_file") else None
        return F.synthetic_model(config["T"], config["K"], config["landmark_n"],
                                 config["tree_depth"], m["seed"], cart_th=th)
    path = os.path.join(root, m["path"])
    if m["kind"] == "file":
        digest = F.sha256_file(path)
        if digest != m["sha256"]:
            raise ValueError(f"{m['path']}: sha256 {digest}, the configuration states {m['sha256']}")
        out = F.read_model(path)
    elif m["kind"] == "module":
        out = _load(path, "benchmark_model_").fields(config, root)
    else:
        raise ValueError(f"unknown model kind {m['kind']!r}")
    if set(out) != set(F.FIELDS) | set(SIZES):
        raise ValueError(f"{m['path']}: fields {sorted(out)}, not {sorted(F.FIELDS + SIZES)}")
    for k in SIZES:
        if out[k] != config[k]:
            raise ValueError(f"{m['path']}: {k} = {out[k]}, the configuration states {config[k]}")
    return out


def image_seed(seed: int, i: int) -> int:
    return (seed % (1 << 62)) * IMAGES_PER_SEED + i


def make_pool(traffic: dict, seed: int) -> np.ndarray:
    """The traffic's pool of images, [pool, H, W] uint8, from `seed`."""
    h, w, n = traffic["height"], traffic["width"], traffic["pool"]
    if n > IMAGES_PER_SEED:
        raise ValueError(f"a pool holds at most {IMAGES_PER_SEED} images")
    kind = traffic["images"]
    if kind == "texture":
        imgs = [F.make_image(h, w, image_seed(seed, i)) for i in range(n)]
    elif kind == "scene":
        imgs = [F.make_scene(h, w, image_seed(seed, i), traffic["faces"])[0] for i in range(n)]
    else:
        raise ValueError(f"unknown image kind {kind!r}")
    return np.stack(imgs)


def batches(traffic: dict) -> List[np.ndarray]:
    """Pool indices of each call of one pass over the pool, in order."""
    b, n = traffic["batch"], traffic["pool"]
    if n % b:
        raise ValueError("the pool must hold a whole number of calls")
    return [np.arange(i, i + b) for i in range(0, n, b)]


class Program:
    """The system under test: the configuration's entry of jda_tpu_torch
    with the traffic's call.  `call(imgs)` returns the answers, one per
    image, as (boxes, scores, shapes, statistic or None); `visits()` the
    program's own cart-visit counter of the last call, where it has one:
    the C API's fused path, which serves single-scale models, keeps one;
    its multi-scale path and the C++ route keep none."""

    def __init__(self, config: dict, traffic: dict, fields: dict, device):
        from jda_tpu_torch import params as P

        params = P.from_arrays(dict(fields, stage_idx=fields["T"] + 1, cart_idx=-1))
        self.entry, self.kind = config["entry"], traffic["call"]
        self.counts_visits = self.entry == "c_api" and not np.any(np.asarray(fields["scale"]))
        if self.entry == "c_api":
            from jda_tpu_torch.detect import Detector

            self.det = Detector(params, device=device, **config.get("detector", {}))
            self.kw = dict(config["detect"])
        elif self.entry == "cpp":
            from jda_tpu_torch.cascador import CppDetector
            from jda_tpu_torch.config import Config

            f = config["fddb"]
            self.det = CppDetector(params, Config(
                fddb_detect_method=f["method"], fddb_minimum_size=f["minimum_size"],
                fddb_step=f["step"], fddb_scale_factor=f["scale"],
                fddb_overlap=f["overlap"], fddb_nms=f["nms"]), device=device)
        else:
            raise ValueError(f"unknown entry {self.entry!r}")
        self.batch = traffic["batch"]
        if (self.entry, self.kind) not in (("c_api", "detect_stream"), ("c_api", "detect"),
                                           ("cpp", "detect_batch")):
            raise ValueError(f"entry {self.entry!r} has no call {self.kind!r}")
        if self.kind == "detect" and self.batch != 1:
            raise ValueError("a detect call takes one image")

    def call(self, imgs: List[np.ndarray]):
        d = self.det
        if self.entry == "c_api":
            if self.kind == "detect_stream":
                res = d.detect_stream(imgs, batch=self.batch, **self.kw)
            else:
                res = [d.detect(imgs[0], **self.kw)]
            return [(r.bboxes, r.scores, r.shapes, None) for r in res]
        res = d.detect_batch(imgs)
        return [(r[0], r[1], r[2], (r[3].patch_n, r[3].face_patch_n, r[3].nonface_patch_n,
                                    r[3].cart_gothrough_n)) for r in res]

    def visits(self) -> Optional[int]:
        if self.counts_visits:
            return int(self.det.last_stats["total_nvis"])
        return None


def reference(config: dict, traffic: dict, fields: dict, pool: np.ndarray, device, dtype=None,
              root: str = ROOT):
    """The reference's answers, counts and ladder for every pool image
    (`answers` of the configuration's reference module)."""
    return reference_module(config, root).answers(config, traffic, fields, pool, device, dtype)


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

CHECKS = ("wrong_answers", "wrong_visits", "score_gap", "shape_gap_px")


def compare(served, want, visits_served=None, visits_want=None) -> Dict[str, float]:
    """Served answers against the reference's, pairwise: `wrong_answers`,
    those whose boxes differ (values or order); `wrong_visits`, those whose
    DetectionStatistic differs, and calls whose cart-visit counter differs;
    `score_gap` and `shape_gap_px`, the widest score and landmark gaps over
    the boxes found in both; `differing`, answers not equal in every
    field."""
    out = dict(wrong_answers=0, wrong_visits=0, score_gap=0.0, shape_gap_px=0.0, differing=0)
    for got, ref in zip(served, want):
        boxes_ok = got[0].shape == ref[0].shape and np.array_equal(got[0], ref[0])
        out["wrong_answers"] += not boxes_ok
        out["wrong_visits"] += got[3] != ref[3]
        at = {b: i for i, b in enumerate(map(tuple, np.asarray(ref[0]).tolist()))}
        pairs = [(i, at[b]) for i, b in enumerate(map(tuple, np.asarray(got[0]).tolist())) if b in at]
        gaps = (0.0, 0.0)
        if pairs:
            gi, ri = (list(v) for v in zip(*pairs))
            gaps = tuple(float(np.max(np.abs(np.asarray(got[k], np.float64)[gi]
                                              - np.asarray(ref[k], np.float64)[ri])))
                         for k in (1, 2))
        out["score_gap"] = max(out["score_gap"], gaps[0])
        out["shape_gap_px"] = max(out["shape_gap_px"], gaps[1])
        out["differing"] += not boxes_ok or got[3] != ref[3] or gaps != (0.0, 0.0)
    if visits_served is not None:
        out["wrong_visits"] += sum(int(a != b) for a, b in zip(visits_served, visits_want))
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[k] <= limits[k] for k in CHECKS)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Readings:
    """What a run measured, for the metric readers."""

    setup_s: float = 0.0
    window_s: float = 0.0  # first call's start to last call's end
    images: int = 0
    calls: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    trace: object = None  # trace.DeviceTrace of a traced run
    # least time of the traced calls' dense filter; None where the reference
    # counts no stage-0 visits and survivors
    dense0_bound_s: Optional[float] = None
    # the cascade's counted operations of the traced calls; None where the
    # reference module counts none
    traced_ops: Optional[int] = None


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=None):
    """Run the cell `c` (as `resolve` returns it); with `trace`, every call
    of the window is profiled.  Returns the result line's dict without
    `device`, the comparison's numbers, the memory peak in bytes and the
    run's `Readings`."""
    import torch

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    config, traffic = c["config"], c["traffic"]
    marks = [("imports", time.perf_counter())]
    fields = model_fields(config)
    marks.append(("model", time.perf_counter()))
    pool = make_pool(traffic, seed)
    calls = batches(traffic)
    marks.append(("inputs", time.perf_counter()))
    program = Program(config, traffic, fields, device)
    marks.append(("detector", time.perf_counter()))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    tracer = None
    if trace:
        from benchmark.trace import DeviceTrace

        tracer = DeviceTrace()
    for k, idx in enumerate(calls[:2]):  # warm-up: the cell's only shape, twice
        if tracer is not None and k == 1:  # and the profiler's first start
            DeviceTrace().cycle(lambda: program.call(list(pool[idx])))
        else:
            program.call(list(pool[idx]))
    sync()
    marks.append(("warm-up", time.perf_counter()))
    log("set-up: " + ", ".join(f"{name} {t - prev:.3f} s" for (name, t), prev
                              in zip(marks, [t_start] + [t for _, t in marks[:-1]])))
    r = Readings(trace=tracer)
    served, served_idx, visits = [], [], []
    t0 = time.perf_counter()
    r.setup_s = t0 - t_start
    i = 0
    while True:
        idx = calls[i % len(calls)]
        imgs = list(pool[idx])
        ts = time.perf_counter()
        if tracer is None:
            out = program.call(imgs)
        else:
            out = tracer.cycle(lambda: program.call(imgs))
        te = time.perf_counter()
        r.latencies_s.append(te - ts)
        served.append(out)
        served_idx.append(idx)
        visits.append(program.visits())
        i += 1
        if te - t0 >= seconds:
            break
    sync()
    r.window_s = time.perf_counter() - t0 if tracer is None else tracer.window_s
    r.calls = len(served)
    r.images = sum(len(x) for x in served_idx)
    memory_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    del program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = reference_module(config)
    want, per, ladder = ref.answers(config, traffic, fields, pool, device)
    flat_served = [a for out in served for a in out]
    flat_want = [want[j] for idx in served_idx for j in idx]
    has_visits = visits[0] is not None
    numbers = compare(
        flat_served, flat_want,
        visits if has_visits else None,
        [sum(per[j]["visits"] for j in idx) for idx in served_idx] if has_visits else None,
    )
    log(f"reference and comparison: {time.perf_counter() - t_ref:.1f} s")

    if tracer is not None:
        if hasattr(ref, "counted_ops"):
            r.traced_ops = sum(ref.counted_ops(per[k], config) for idx in served_idx for k in idx)
        if all("visits0" in p and "alive0" in p for p in per):
            H, W = pool.shape[1:]
            n = per[0]["windows"]
            K, depth = config["K"], config["tree_depth"]
            node_n = (1 << (depth - 1)) - 1
            r.dense0_bound_s = 0.0
            for idx in served_idx:
                r.dense0_bound_s += max(Y.ladder_bound(
                    len(idx), H, W, len(ladder), n, K, node_n,
                    sum(per[k]["visits0"] for k in idx), depth,
                    lbf_bytes=sum(per[k]["alive0"] for k in idx) * Y.lbf_words(K) * 4))

    entries = c["per_layer"] if trace else c["end_to_end"]
    metrics = {}
    for m in entries:
        v = metric_reader(m["name"])(r)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct = judge(numbers, c["limits"])
    line = dict(correct=correct, attempted=r.images, failed=numbers["differing"],
                metrics=metrics)
    if tracer is not None:
        line["breakdown"] = tracer.breakdown()
    return line, numbers, memory_peak, r


def forbidden_modules() -> List[str]:
    """Modules loaded whose top-level name is JAX's, its libraries' or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
