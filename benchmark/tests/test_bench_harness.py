"""The harness finds its cells, configurations and metrics by name, loads
no JAX, and its comparison catches a broken timed path."""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from benchmark import frozen as F
from benchmark import harness as H
from benchmark import reference as R

SPEC = H.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    c = H.resolve(SPEC, workload)
    assert c["config"]["name"] == c["cell"]["config"]
    assert set(c["limits"]) == set(H.CHECKS)
    names = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(H.metric_reader(m["name"]))
    for m in c["per_layer"]:
        assert m["moves"] in names  # the cell reports the metric it moves
    fields = H.model_fields(c["config"])
    assert fields["T"] == 5 and fields["K"] == 540 and fields["W"].shape == (5, 4320, 54)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        H.resolve(SPEC, "no_such_cell")
    with pytest.raises(KeyError):
        H.metric_reader("no_such_metric")
    bad = dict(SPEC, workloads=[dict(SPEC["workloads"][0], config="no_such_config")])
    with pytest.raises(KeyError):
        H.resolve(bad, bad["workloads"][0]["name"])


def test_spec_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert e2e == {"images_per_s", "latency_p50_ms", "latency_p90_ms", "setup_s"}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            for k in ("why", "layer", "source"):
                assert len(e.get(k, "x")) <= 200 and "\n" not in e.get(k, "")
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        cells_moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])["workloads"]
        assert set(m["workloads"]) <= set(cells_moved)
    assert all(w["chips"] == 1 for w in SPEC["workloads"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_no_jax_is_loaded():
    """A tiny cell run end to end on the CPU in a fresh process loads no
    module whose top-level name is JAX's or the JAX package's."""
    code = (
        "import sys, time; sys.path[0:0] = [%r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from benchmark import harness as H, trace, calibrate\n"
        "c = H.resolve(H.load_spec(), 'vga_stream_b16')\n"
        "c['config'] = dict(c['config'], T=1, K=16, model=dict(kind='synthetic', seed=7))\n"
        "c['traffic'] = dict(c['traffic'], height=48, width=64, pool=2, batch=2)\n"
        "line, nums, _, _ = H.run_cell(c, 5, 0.2, False, 'cpu', time.perf_counter())\n"
        "print(line['correct'], sorted({m.split('.')[0] for m in sys.modules}))\n" % H.ROOT
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=H.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    ok, names = out.stdout.strip().splitlines()[-1].split(" ", 1)
    names = eval(names)
    assert ok == "True"
    assert "jda_tpu_torch" in names
    assert not set(names) & {"jax", "jaxlib", "flax", "jda_tpu"}


def tiny(workload, spec=SPEC):
    c = H.resolve(spec, workload)
    kind = c["config"]["model"]["kind"]
    if kind == "synthetic":
        c["config"] = dict(c["config"], T=2, K=24, model=dict(kind="synthetic", seed=7))
    if kind == "file":
        c["traffic"] = dict(c["traffic"], height=200, width=240, pool=2, batch=2, faces=1)
    else:
        c["traffic"] = dict(c["traffic"], height=96, width=128, pool=4,
                            batch=min(c["traffic"]["batch"], 2))
    return c


def run(c):
    torch.set_num_threads(4)
    line, nums, _, _ = H.run_cell(c, 2**31 + 11, 0.5, False, "cpu", time.perf_counter(),
                                  log=lambda *a: None)
    return line, nums


def unchanged_state(monkeypatch):
    """A stage's regression returns its state unchanged."""
    from jda_tpu_torch.ops import cascade as C

    monkeypatch.setattr(C, "apply_regression", lambda W, leaves, state, **kw: state)


def half_batch(monkeypatch):
    """Half of each batch left out: its answers are those of the other half."""
    from jda_tpu_torch.cascador import CppDetector
    from jda_tpu_torch.detect import Detector

    def halve(fn):
        def wrapped(self, grays, *a, **kw):
            keep = max(1, len(grays) // 2)
            out = fn(self, grays[:keep], *a, **kw)
            return (out * len(grays))[: len(grays)]
        return wrapped

    for cls, name in ((Detector, "detect_stream"), (Detector, "detect_batch"),
                      (CppDetector, "detect_batch")):
        monkeypatch.setattr(cls, name, halve(getattr(cls, name)))


def alter_answers(monkeypatch, fn):
    """Apply `fn(boxes, scores)` to every answer where the program produces
    it: the C API's harvest and the C++ route's NMS and relocation."""
    from jda_tpu_torch import cascador
    from jda_tpu_torch.detect import Detector

    harvest = Detector._harvest_batch

    def harvested(self, *a, **kw):
        out = harvest(self, *a, **kw)
        for r in out:
            fn(r.bboxes, r.scores)
        return out

    relocate = cascador._nms_relocate

    def relocated(*a, **kw):
        rects, scores, shapes = relocate(*a, **kw)
        fn(rects, scores)
        return rects, scores, shapes

    monkeypatch.setattr(Detector, "_harvest_batch", harvested)
    monkeypatch.setattr(cascador, "_nms_relocate", relocated)


def altered_score(monkeypatch):
    """One answer altered where it is produced: each image's first score
    raised by 0.01."""
    def raise_first(boxes, scores):
        scores[:1] += 0.01
    alter_answers(monkeypatch, raise_first)


def moved_box(monkeypatch):
    """One answer altered where it is produced: every box moved by 1 px."""
    def move(boxes, scores):
        boxes[:, 0] += 1
    alter_answers(monkeypatch, move)


@pytest.mark.parametrize("workload", ["vga_stream_b16", "fddb_scenes_m1_b8", "hd_single_b1"])
def test_sound_run_is_correct(workload):
    line, nums = run(tiny(workload))
    assert line["correct"], nums
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in H.resolve(SPEC, workload)["end_to_end"]}


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_score, moved_box])
@pytest.mark.parametrize("workload", ["vga_stream_b16", "fddb_scenes_m1_b8"])
def test_broken_path_is_not_correct(workload, fault, monkeypatch):
    """Each fault a cell can have, planted under the timed path, makes
    `correct` false.  (There is no exchange between chips to leave out: every
    cell runs on one card.)"""
    fault(monkeypatch)
    line, nums = run(tiny(workload))
    assert not line["correct"], nums


@pytest.mark.cuda
def test_run_on_the_card():
    """The command itself on a card, short: a result line with `correct`."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "vga_stream_b16", "--seed", "3",
         "--seconds", "2", "--trace", "0"], capture_output=True, text=True, cwd=H.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


def test_pool_is_the_seeds():
    t = H.resolve(SPEC, "vga_stream_b16")["traffic"]
    t = dict(t, height=32, width=40, pool=4)
    assert np.array_equal(H.make_pool(t, 9), H.make_pool(t, 9))
    assert not np.array_equal(H.make_pool(t, 9), H.make_pool(t, 10))
    assert os.path.exists(os.path.join(H.BENCH, "run.py"))


# ---------------------------------------------------------------------------
# a configuration that brings its own model source, reference and options
# ---------------------------------------------------------------------------

MODEL_MODULE = """
from benchmark import frozen as F


def fields(config, root):
    m = config["model"]
    return F.synthetic_model(config["T"], config["K"], config["landmark_n"],
                             config["tree_depth"], m["seed"]){change}
"""

REFERENCE_MODULE = """
{imports}
from benchmark import reference as R


def answers(config, traffic, fields, pool, device, dtype=None):
    out, per, ladder = R.answers(config, traffic, fields, pool, device, dtype)
{plant}
    return out, per, ladder
"""

# the first score of the first image with a box, raised by 0.01
RAISED_SCORE = """    i = next(i for i, a in enumerate(out) if len(a[1]))
    out[i][1][:1] += 0.01"""


def spec_with(tmp_path, config, workload="vga_stream_b16"):
    """SPEC with the cell `workload` (its traffic and limits) under
    `config`, written to a file of its own in `tmp_path`."""
    path = tmp_path / (config["name"] + ".json")
    path.write_text(json.dumps(config))
    cell = dict(next(w for w in SPEC["workloads"] if w["name"] == workload), config=config["name"])
    return dict(SPEC, configs=[dict(SPEC["configs"][0], name=config["name"], file=str(path))],
                workloads=[cell])


def own_files(tmp_path, model_change="", imports="", plant="    pass"):
    """A configuration at vga_stream_b16's sizes (shrunk) whose model
    module and reference module are new files, named by absolute path."""
    model = tmp_path / "own_model.py"
    model.write_text(MODEL_MODULE.format(change=model_change))
    ref = tmp_path / "own_reference.py"
    ref.write_text(REFERENCE_MODULE.format(imports=imports, plant=plant))
    base = H.resolve(SPEC, "vga_stream_b16")["config"]
    return dict(base, name="own_synth", T=2, K=24, reference=str(ref),
                model=dict(kind="module", path=str(model), seed=11))


@pytest.mark.parametrize("case, kw, want", [
    ("sound", {}, True),
    ("raised_score", dict(plant=RAISED_SCORE), False),
    ("imports_program", dict(imports="from jda_tpu_torch.detect import Detector"), "refused"),
    ("imports_jax_by_name", dict(imports="import importlib; importlib.import_module('jax')"),
     "refused"),
    ("imports_the_harness", dict(imports="from benchmark import harness"), "refused"),
])
def test_configuration_brings_its_own_files(case, kw, want, tmp_path):
    """A cell whose configuration names its own reference and a `module`
    model runs through run_cell with new files only; a fault planted in
    that reference's answers makes `correct` false; a reference that
    imports the program or JAX, itself or through a benchmark module, is
    refused at resolve."""
    spec = spec_with(tmp_path, own_files(tmp_path, **kw))
    if want == "refused":
        with pytest.raises(ValueError, match="imports"):
            H.resolve(spec, "vga_stream_b16")
        return
    c = tiny("vga_stream_b16", spec)
    fields = H.model_fields(c["config"])
    assert np.array_equal(fields["W"], F.synthetic_model(2, 24, 27, 4, 11)["W"])
    assert H.reference_module(c["config"]) is not R
    line, nums = run(c)
    assert line["correct"] is want, nums
    assert line["attempted"] > 0 and (line["failed"] > 0) is (not want)


@pytest.mark.parametrize("change, match", [
    ("", None),
    (" | dict(K=25)", "K = 25"),
    (" | dict(extra=0)", "fields"),
])
def test_module_model_is_checked(change, match, tmp_path):
    """A `module` model's arrays are held to the configuration's sizes and
    to the model's set of fields, as a model file's are."""
    config = own_files(tmp_path, model_change=change)
    if match is None:
        assert set(H.model_fields(config)) == set(F.FIELDS) | set(H.SIZES)
    else:
        with pytest.raises(ValueError, match=match):
            H.model_fields(config)


def parent_reference(config, traffic, fields, pool, device, dtype=None):
    """harness.reference as it was before a configuration could name its
    own reference (frozen copy): the default reference must give exactly
    this."""
    c = R.Cascade(fields, device, torch.float32 if dtype is None else dtype)
    H_, W = pool.shape[1:]
    if config["entry"] == "c_api":
        k = config["detect"]
        ladder = R.c_api_ladder(H_, W, k["scale"], k["min_size"], k["max_size"])
        per, xyw = R.run_cascade(c, pool, ladder, rounding=False)
        answers = [a + (None,) for a in R.c_api_answers(per, xyw, k["th"], k["nms_overlap"])]
    else:
        f = config["fddb"]
        if f["method"] != 1:
            raise ValueError("the reference runs fddb method 1 only")
        ladder = R.cpp_m1_ladder(H_, W, f["minimum_size"], f["step"], f["scale"])
        per, xyw = R.run_cascade(c, pool, ladder, rounding=True)
        answers = R.cpp_answers(per, xyw, f["overlap"])
    return answers, per, ladder


def same(a, b) -> bool:
    """Equal in every field, type and dtype included."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("workload", ["vga_stream_b16", "fddb_scenes_m1_b8", "hd_single_b1"])
def test_default_reference_is_the_parents(workload):
    """The existing cells' answers, per-image counts and ladder through
    reference.answers equal, field for field, the parent's harness.reference
    on the same tiny pool."""
    torch.set_num_threads(4)
    c = tiny(workload)
    config, traffic = c["config"], c["traffic"]
    assert "reference" not in config and H.reference_module(config) is R
    fields = H.model_fields(config)
    pool = H.make_pool(traffic, 2**31 + 13)
    got = H.reference(config, traffic, fields, pool, "cpu")
    want = parent_reference(config, traffic, fields, pool, "cpu")
    assert same(got, want)
    assert sum(len(a[0]) for a in want[0]) > 0


def program_ignores_rounding(monkeypatch):
    """The program's Detector built without the configuration's rounding."""
    from jda_tpu_torch.detect import Detector

    init = Detector.__init__

    def plain(self, *a, rounding=False, **kw):
        init(self, *a, **kw)

    monkeypatch.setattr(Detector, "__init__", plain)


@pytest.mark.parametrize("fault, want", [(None, True), (program_ignores_rounding, False)])
@pytest.mark.parametrize("workload", ["vga_stream_b16", "hd_single_b1"])
def test_rounding_reaches_both_sides(workload, fault, want, monkeypatch):
    """`"detector": {"rounding": true}` reaches the program's Detector and
    the default reference: they agree, the answers differ from those of a
    run without it on some pool image, and a program that drops the option
    is not correct."""
    c = tiny(workload)
    config = dict(c["config"], detector={"rounding": True})
    H.check_config(config)
    c["config"] = config
    fields = H.model_fields(config)
    pool = H.make_pool(c["traffic"], 2**31 + 11)
    rounded = H.reference(config, c["traffic"], fields, pool, "cpu")[0]
    truncated = H.reference(dict(config, detector={}), c["traffic"], fields, pool, "cpu")[0]
    assert not all(same(a, b) for a, b in zip(rounded, truncated))
    if fault is not None:
        fault(monkeypatch)
    assert H.Program(config, c["traffic"], fields, "cpu").det.rounding is want
    line, nums = run(c)
    assert line["correct"] is want, nums


@pytest.mark.parametrize("workload, detector", [
    ("vga_stream_b16", {"round": True}),
    ("vga_stream_b16", {"rounding": 1}),
    ("fddb_scenes_m1_b8", {"rounding": True}),
])
def test_detector_options_are_checked(workload, detector, tmp_path):
    """An unknown `detector` key, a value of another type, or options on
    the C++ entry are refused at resolve."""
    config = dict(H.resolve(SPEC, workload)["config"], detector=detector)
    with pytest.raises(ValueError, match="detector"):
        H.resolve(spec_with(tmp_path, config, workload), workload)


@pytest.mark.parametrize("multi_scale", [False, True])
def test_visits_where_the_program_counts_them(multi_scale):
    """The C API's visit counter is read on single-scale models and not
    asked of a multi-scale model, whose path keeps none."""
    torch.set_num_threads(4)
    c = tiny("hd_single_b1")
    fields = F.synthetic_model(2, 24, 27, 4, 7)
    if multi_scale:
        rng = np.random.default_rng(0)
        fields["scale"] = rng.integers(0, 3, fields["scale"].shape).astype(np.int32)
    program = H.Program(c["config"], c["traffic"], fields, "cpu")
    program.call([F.make_image(96, 128, 5)])
    v = program.visits()
    assert (v is None) if multi_scale else (isinstance(v, int) and v > 0)
