"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back to the CPU on their own."""

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
        "jda_tpu_torch.cli, jda_tpu_torch.__main__, sys; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
        "'jda_tpu.')) or m == 'jda_tpu']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, env=env, cwd=ROOT)


def test_sources_name_no_jax():
    pat = re.compile(r"import jax\b|\bjda_tpu\.|\bfrom jda_tpu |\bimport jda_tpu\b")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "jda_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu"))]
    hits = []
    for f in files:
        with open(f) as fh:
            for i, line in enumerate(fh, 1):
                if pat.search(line):
                    hits.append(f"{os.path.relpath(f, ROOT)}:{i}: {line.strip()}")
    assert not hits, hits


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
    with pytest.raises(NotImplementedError, match="A.12"):
        Trainer(c, mesh=object(), device="cpu")
    assert Trainer(c, device="cpu").device.type == "cpu"
