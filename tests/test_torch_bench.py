"""The port's measurement entry points on the CPU (bench_torch.py,
scripts/bench_1080p_torch.py) against the JAX package's (bench.py,
scripts/bench_1080p.py): the same images, workload and keys; a small
run's detections against jda_tpu and the native C library."""

import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench  # noqa: E402  (no JAX at module level)
import bench_torch as BT  # noqa: E402
from jda_tpu import params as JP  # noqa: E402
from jda_tpu.detect import Detector as JDetector  # noqa: E402
from jda_tpu_torch import native, oracle  # noqa: E402
from jda_tpu_torch import params as TP  # noqa: E402
from jda_tpu_torch.detect import Detector  # noqa: E402
from scripts import bench_1080p_torch as B1080  # noqa: E402


def _literal(node):
    return ast.literal_eval(ast.unparse(node))


def _workload(path):
    """What a bench script reads off its source: env knobs and defaults,
    the detection arguments, the model's arguments, the image and frame
    shapes and first seeds, and the JSON line's keys."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {"env": {}, "shapes": [], "seeds": [], "keys": set()}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            fn = ast.unparse(node.func)
            if fn == "os.environ.get":
                out["env"][_literal(node.args[0])] = ast.unparse(node.args[1]).lower()
            elif fn == "dict" and {k.arg for k in node.keywords} >= {"scale", "th"}:
                out["kw"] = {k.arg: _literal(k.value) for k in node.keywords}
            elif fn.endswith("synthetic_model"):
                out["model"] = {k.arg: _literal(k.value) for k in node.keywords
                                if k.arg not in (None, "drop_profile")}
            elif fn == "make_image" and isinstance(node.keywords[0].value.left, ast.Constant):
                out["seeds"].append(_literal(node.keywords[0].value.left))
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Tuple):
            if all(isinstance(e, ast.Constant) and isinstance(e.value, int)
                   for e in node.value.elts):
                out["shapes"].append(_literal(node.value))
        elif isinstance(node, ast.Dict):
            out["keys"] |= {k.value for k in node.keys
                            if isinstance(k, ast.Constant) and isinstance(k.value, str)}
    return out


@pytest.mark.parametrize("shape,seed", [((480, 640), 3), ((1080, 1920), 31),
                                        ((96, 128), 5), ((37, 53), 0)])
def test_make_image_equals_bench(shape, seed):
    np.testing.assert_array_equal(BT.make_image(*shape, seed), bench.make_image(*shape, seed))


def test_workload_equals_bench_py():
    """Env knobs and defaults, detection arguments, model, shapes and seeds
    of bench.py, and bench_torch.py's constants equal to them."""
    j = _workload(os.path.join(ROOT, "bench.py"))
    t = _workload(os.path.join(ROOT, "bench_torch.py"))
    knobs = {k: v for k, v in t["env"].items() if k.startswith("BENCH")}
    assert knobs == j["env"] == {"BENCH_BATCH": "'16'", "BENCH_CHUNKS": "'4'",
                                 "BENCH_REPS": "'3'", "BENCH_1080": "'1'",
                                 "BENCH_1080_BATCH": "'4'"}
    assert set(t["env"]) == set(knobs)
    assert BT.KW == j["kw"]
    assert BT.MODEL == j["model"]
    assert [(BT.H, BT.W), (BT.HD_H, BT.HD_W)] == j["shapes"]
    assert [BT.IMAGE_SEED, BT.FRAME_SEED] == j["seeds"]
    jb = _workload(os.path.join(ROOT, "scripts", "bench_1080p.py"))
    tb = _workload(os.path.join(ROOT, "scripts", "bench_1080p_torch.py"))
    knobs = {k: v for k, v in jb["env"].items() if k.startswith("B1080")}
    assert knobs == {"B1080_BATCH": "'2'", "B1080_FRAMES": "str(4 * batch)"}
    assert {k: v for k, v in tb["env"].items() if k.startswith("B1080")} == knobs
    assert jb["kw"] == BT.KW and jb["model"] == BT.MODEL and jb["seeds"] == [BT.FRAME_SEED]
    assert jb["shapes"] == [(BT.HD_H, BT.HD_W)]


@pytest.fixture(scope="module")
def small():
    """A small model through bench_torch.run on the CPU, with the native
    library as the baseline, and the same images through jda_tpu."""
    jm = JP.synthetic_model(T=2, K=40, landmark_n=9, seed=7,
                            drop_profile=JP.realistic_drop_profile(2, 40))
    model = TP.from_arrays(dataclasses.asdict(jm))
    imgs = [BT.make_image(96, 128, seed=3 + i) for i in range(4)]
    frames = [BT.make_image(120, 176, seed=31 + i) for i in range(4)]
    det = Detector(model, device="cpu")
    saved = oracle.available
    oracle.available = lambda: False
    try:
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            base = BT.Baseline(model, tmp)
            line, res = BT.run(det, imgs, frames, 2, 1, base, batch_1080=1)
            nat = [base.det.detect(g, **BT.KW) for g in imgs]
    finally:
        oracle.available = saved
    jres = JDetector(jm).detect_stream(imgs, batch=2, **BT.KW)
    return line, res, nat, jres


def test_small_run_prints_bench_keys(small):
    line, res, nat, jres = small
    keys = _workload(os.path.join(ROOT, "bench.py"))["keys"] - {"p1080_error"}
    assert set(line) == keys | {"baseline", "batch"}
    assert (line["baseline"], line["batch"]) == ("native", 2)
    assert line["vs_baseline"] is not None and line["vs_baseline"] > 0
    assert len(line["runs_images_per_sec"]) == len(line["ref_runs_images_per_sec"]) == 1
    assert line["windows_per_image"] == BT.windows_per_image(96, 128)
    assert line["p1080_windows_per_frame"] == BT.windows_per_image(120, 176)
    json.dumps(line)


def test_small_run_equals_jda_tpu_and_native(small):
    """The stream's detections: jda_tpu's rects exactly and scores within
    2e-4; the native library's boxes exactly and scores within 2e-4."""
    line, res, nat, jres = small
    assert sum(r.n for r in res) > 0, "degenerate fixture"
    for r, j, (nb, _, nsc) in zip(res, jres, nat):
        np.testing.assert_array_equal(r.bboxes, np.asarray(j.bboxes))
        np.testing.assert_allclose(r.scores, np.asarray(j.scores), atol=2e-4, rtol=0)
        np.testing.assert_array_equal(r.bboxes, nb)
        np.testing.assert_allclose(r.scores, nsc, atol=2e-4, rtol=0)


def test_one_thread_restores_the_count():
    lib = native._load()
    n = lib.omp_get_max_threads()
    with BT.one_thread(lib):
        assert lib.omp_get_max_threads() == 1
    assert lib.omp_get_max_threads() == n


def test_bench_1080p_small_run_keys():
    """bench_1080p_torch.run: scripts/bench_1080p.py's keys but the tail
    and canvas mode, which the port does not choose among."""
    m = TP.synthetic_model(T=2, K=40, landmark_n=9, seed=7,
                           drop_profile=TP.realistic_drop_profile(2, 40))
    frames = [BT.make_image(120, 176, seed=31 + i) for i in range(4)]
    line = B1080.run(m, frames, 2, torch.device("cpu"))
    keys = _workload(os.path.join(ROOT, "scripts", "bench_1080p.py"))["keys"]
    assert set(line) == keys - {"tail", "canvas"}
    assert (line["frames"], line["batch"]) == (4, 2)
    assert len(line["lat_runs"]) == 5


@pytest.mark.parametrize("script", ["bench", "bench_1080p"])
def test_main_needs_cuda_unless_told_cpu(monkeypatch, script):
    """Without CUDA main() raises before any image is made; with --device
    cpu it runs the workload's sizes from the env knobs on the CPU."""
    mod = BT if script == "bench" else B1080
    made, seen = [], []
    real = BT.make_image
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(BT, "make_image", lambda *a, **k: made.append(a) or real(*a, **k))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    assert made == []
    for k, v in dict(BENCH_BATCH="2", BENCH_CHUNKS="1", BENCH_1080_BATCH="1",
                     B1080_BATCH="1", B1080_FRAMES="2").items():
        monkeypatch.setenv(k, v)
    if script == "bench":
        monkeypatch.setattr(BT, "run", lambda det, imgs, frames, batch, reps, base, b1080:
                            seen.append((det.device.type, len(imgs), len(frames), batch, reps,
                                         base.name, b1080)) or ({"value": 1.0}, None))
        mod.main(["--device", "cpu"])
        assert seen[0][:5] == ("cpu", 2, 4, 2, 3) and seen[0][6] == 1
    else:
        monkeypatch.setattr(B1080, "run", lambda model, frames, batch, device:
                            seen.append((device.type, len(frames), batch)) or {})
        mod.main(["--device", "cpu"])
        assert seen == [("cpu", 2, 1)]
    assert made
