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
        "import jda_tpu_torch, jda_tpu_torch.native, jda_tpu_torch.ops.fused, sys; "
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
