"""`python -m jda_tpu_torch` on the CPU: train from face.txt and background
files on the tests/test_cli.py workspace, compared with the JAX CLI's model
on the same workspace, then resume, dump, test and detect."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_cli import workspace  # noqa: F401  (module fixture: the files)
from torch_train_util import model_diffs, one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def trained(workspace):  # noqa: F811
    """The JAX CLI and the port's CLI (--device cpu) train on the same
    workspace, each into its own model, corpus cache and snapshots."""
    from jda_tpu import cli as jcli
    from jda_tpu_torch import cli

    d = workspace
    out = {}
    for tag, main, extra in (("jax", jcli.main, []), ("port", cli.main, ["--device", "cpu"])):
        rc = main(
            ["--config", str(d / "config.json")] + extra + [
                "train",
                "--model", str(d / f"{tag}.model"),
                "--data-cache", str(d / f"{tag}.data"),
                "--snapshot-dir", str(d / f"{tag}_snaps"),
            ]
        )
        assert rc == 0
        out[tag] = d / f"{tag}.model"
    return d


def test_cli_train_matches_jax(trained):
    from jda_tpu.params import load_model as jload
    from jda_tpu_torch.params import load_model

    d = trained
    a, b = jload(str(d / "jax.model")), load_model(str(d / "port.model"))
    assert (b.T, b.K, b.landmark_n) == (1, 6, 5)
    assert np.abs(b.W[0]).sum() > 0
    assert model_diffs(a, b) == []
    # the corpus cache written before training: byte-identical
    assert (d / "jax.data").read_bytes() == (d / "port.data").read_bytes()
    # the stage-end snapshots of both runs
    assert len(os.listdir(d / "port_snaps")) == len(os.listdir(d / "jax_snaps")) == 2


def test_cli_resume_dump_test_detect(trained, tmp_path):
    from jda_tpu_torch import cli
    from jda_tpu_torch.params import load_model

    d = trained
    cfg = ["--config", str(d / "config.json"), "--device", "cpu"]
    model = str(tmp_path / "resumed.model")
    shutil.copy(d / "port.model", model)
    # the model's cursor is complete: resume reloads model and corpus,
    # trains nothing and writes the model again
    assert cli.main(cfg + ["resume", "--model", model, "--data-cache", str(d / "port.data"),
                           "--snapshot-dir", str(tmp_path / "snaps")]) == 0
    assert model_diffs(load_model(model), load_model(str(d / "port.model"))) == []
    assert cli.main(cfg + ["dump", "--data-cache", str(d / "port.data"),
                           "--out", str(tmp_path / "dump")]) == 0
    assert len(os.listdir(tmp_path / "dump" / "pos")) == 120  # 60 faces, flipped too
    assert cli.main(cfg + ["test", "--model", model, "--out", str(tmp_path / "test_result")]) == 0
    assert os.path.exists(tmp_path / "test_result" / "000000.jpg")
    # --device also after the command
    assert cli.main(["--config", str(d / "config.json"), "detect", str(d / "scene.png"),
                     "--model", model, "--device", "cpu"]) == 0


def test_module_entry_point(trained, tmp_path):
    """`python -m jda_tpu_torch` runs the same main, in a process that
    never imports JAX."""
    d = trained
    code = (
        "import sys, runpy\n"
        "sys.argv = sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('jda_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'jda_tpu')]\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run(
        [sys.executable, "-c", code, "jda_tpu_torch", "--config", str(d / "config.json"),
         "--device", "cpu", "detect", str(d / "scene.png"), "--model", str(d / "port.model")],
        env=env, cwd=ROOT, capture_output=True, text=True,
    )
    assert r.returncode == 0, r.stderr
    assert "faces" in r.stdout
