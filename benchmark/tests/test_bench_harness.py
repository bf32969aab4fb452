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

from benchmark import harness as H

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


def tiny(workload):
    c = H.resolve(SPEC, workload)
    if c["config"]["model"]["kind"] == "synthetic":
        c["config"] = dict(c["config"], T=2, K=24, model=dict(kind="synthetic", seed=7))
        c["traffic"] = dict(c["traffic"], height=96, width=128, pool=4,
                            batch=min(c["traffic"]["batch"], 2))
    else:
        c["traffic"] = dict(c["traffic"], height=200, width=240, pool=2, batch=2, faces=1)
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
