"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

import glob
import os
import re
import subprocess
import sys

import pytest
import torch

import jda_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    code = (
        "import jda_tpu_torch, jda_tpu_torch.native, jda_tpu_torch.ops.fused, "
        "jda_tpu_torch.cascador, jda_tpu_torch.fddb, jda_tpu_torch.data, "
        "jda_tpu_torch.train, jda_tpu_torch.train.boost, jda_tpu_torch.train.mining, "
        "jda_tpu_torch.cli, jda_tpu_torch.__main__, jda_tpu_torch.entry, "
        "jda_tpu_torch.train.sharded, jda_tpu_torch.train.dryrun, "
        "jda_tpu_torch.oracle, jda_tpu_torch.jpeg, sys; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'jda_tpu.')) or m == 'jda_tpu']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


# the port's counterparts of the JAX package's scripts and bench.py
TORCH_SCRIPTS = sorted(glob.glob(os.path.join(ROOT, "scripts", "*_torch.py"))) + [
    os.path.join(ROOT, "bench_torch.py")]
NO_CV2 = re.compile(r"import cv2\b|\bfrom cv2\b")


def test_sources_name_no_jax():
    """No source of the port, chip_smoke.py, bench_torch.py or the
    scripts/*_torch.py counterparts names JAX or the JAX package; those
    scripts name no OpenCV either."""
    pat = re.compile(r"import jax\b|\bjda_tpu\.|\bfrom jda_tpu |\bimport jda_tpu\b")
    files = [os.path.join(ROOT, "chip_smoke.py")] + TORCH_SCRIPTS
    for d, _, names in os.walk(os.path.join(ROOT, "jda_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu"))]
    assert len(TORCH_SCRIPTS) >= 3, TORCH_SCRIPTS
    hits = []
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                if pat.search(line) or (f in TORCH_SCRIPTS and NO_CV2.search(line)):
                    hits.append(f"{os.path.relpath(f, ROOT)}:{i}: {line.strip()}")
    assert not hits, hits


def test_flagship_scripts_import_no_jax_or_cv2():
    """The flagship workflow's scripts import neither JAX, the JAX package
    nor OpenCV: the card's machine has none of them."""
    mods = ", ".join(os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".") for f in TORCH_SCRIPTS)
    code = (
        f"import {mods}, sys; "
        "bad = [m for m in sys.modules if m in ('jax', 'cv2', 'jda_tpu') or "
        "m.startswith(('jax.', 'cv2.', 'jda_tpu.'))]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_flagship_scripts_default_device_without_cuda_raises(monkeypatch, tmp_path):
    """main() of the training and evaluation scripts runs on CUDA unless
    given --device cpu; without CUDA the default raises before any work
    (the finalisation script touches no device)."""
    sys.path.insert(0, ROOT)
    from scripts import eval_synth_scenes_torch as E
    from scripts import train_flagship_torch as F

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        F.main(["--n-pos", "8", "--out", out])
    assert not os.path.exists(out)
    model = os.path.join(ROOT, "models", "flagship_synth.model")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.main([model, str(tmp_path / "eval.json")])
    assert not os.path.exists(tmp_path / "eval.json")
    assert F.parse_args(["--device", "cpu"]).device == "cpu"


def test_codec_and_resize_import_no_cv2():
    """The JPEG codec and the OpenCV models stand in for OpenCV: importing
    them loads no cv2 (nor JAX)."""
    code = (
        "import jda_tpu_torch.jpeg, jda_tpu_torch.ops.resize, jda_tpu_torch.fddb, sys; "
        "bad = [m for m in sys.modules if m in ('jax', 'cv2') or "
        "m.startswith(('jax.', 'cv2.'))]; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_evaluation_scripts_default_device_without_cuda_raises(monkeypatch, tmp_path):
    """main() of the held-out and FDDB-format scripts runs on CUDA unless
    given --device cpu; without CUDA the default raises before any work."""
    sys.path.insert(0, ROOT)
    from scripts import eval_holdout_torch as H
    from scripts import synth_fddb_torch as S

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = os.path.join(ROOT, "models", "flagship_synth.model")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        H.main([model, str(tmp_path / "holdout.json")])
    assert not os.path.exists(tmp_path / "holdout.json")
    tree = tmp_path / "tree"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        S.main([model, "--dir", str(tree), "--out-json", str(tmp_path / "s.json")])
    assert not os.path.exists(tree) and not os.path.exists(tmp_path / "s.json")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = jda_tpu_torch.synthetic_model(T=1, K=8, landmark_n=9, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        jda_tpu_torch.Detector(m)


def test_cpp_detector_default_device_without_cuda_raises(monkeypatch):
    from jda_tpu_torch.cascador import CppDetector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = jda_tpu_torch.synthetic_model(T=1, K=8, landmark_n=9, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CppDetector(m, jda_tpu_torch.Config(T=1, K=8, landmark_n=9))


def test_training_entry_points_default_device_without_cuda_raises(monkeypatch):
    """Trainer, DeviceMiner and the CLI run on CUDA unless given the CPU."""
    from jda_tpu_torch import cli
    from jda_tpu_torch.data import NegGenerator
    from jda_tpu_torch.train.boost import Trainer
    from jda_tpu_torch.train.mining import DeviceMiner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    c = jda_tpu_torch.Config(T=1, K=8, landmark_n=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceMiner(NegGenerator(c), c)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", "/nonexistent.json", "train"])
    with pytest.raises(TypeError, match="DeviceMesh"):
        Trainer(c, mesh=object(), device="cpu")
    assert Trainer(c, device="cpu").device.type == "cpu"


def test_canvas_miner_default_device(monkeypatch):
    """CanvasHardMiner, like the trainer that builds it, runs on CUDA unless
    given another device, and without CUDA its default raises."""
    from jda_tpu_torch.data import NegGenerator
    from jda_tpu_torch.train.mining import CanvasHardMiner

    c = jda_tpu_torch.Config(T=1, K=8, landmark_n=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert CanvasHardMiner(NegGenerator(c), c).device.type == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CanvasHardMiner(NegGenerator(c), c)
    assert CanvasHardMiner(NegGenerator(c), c, device="cpu").device.type == "cpu"


def test_mesh_entry_points_default_device_without_cuda_raises(monkeypatch):
    """entry(), dryrun_multichip and MeshRun run on CUDA unless given the
    CPU; without CUDA their default raises before any process starts."""
    from jda_tpu_torch import entry as E

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.dryrun_multichip(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.MeshRun(E.run_each, 2, [])
