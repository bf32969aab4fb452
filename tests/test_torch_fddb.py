"""The FDDB harness (jda_tpu_torch.fddb.run_fddb) against the JAX package's,
on the CPU.

A temporary FDDB folder holds four of data/fddb_synth's fold-1 JPEGs (VGA)
and the fold's lists.  Both harnesses run the same synthetic model over it
for both detection methods: the fold-01-out.txt files are byte-identical
and the returned counts equal.  The port reads its images through the
`imread=` seam where OpenCV is missing; that seam is tested here too.
"""

import dataclasses
import os
import shutil
import sys

import numpy as np
import pytest

from jda_tpu import params as JP
from jda_tpu.config import Config as JConfig
from jda_tpu.fddb import run_fddb as j_run_fddb
from jda_tpu_torch import params as TP
from jda_tpu_torch.config import Config
from jda_tpu_torch.fddb import read_ellipses, read_fold, run_fddb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "data", "fddb_synth")
NAMES = [f"synth/fold_01/img_{i:03d}" for i in range(4)]
COUNTS = ("images", "windows", "face_windows", "average_cart_n")
# stage 0 passes about 2 % of the windows, as a trained cascade does (the
# JAX package sizes its survivor lanes for that), stage 1 about 29 %
DROP = np.concatenate([np.full(24, 0.15), np.full(24, 0.05)])


def _cfg(fddb_dir, method):
    return dict(
        T=2, K=24, landmark_n=5, tree_depth=4, img_o_size=48, img_h_size=36,
        img_q_size=24, fddb_minimum_size=48, fddb_step=8, fddb_scale_factor=2.5,
        fddb_overlap=0.3, fddb_nms=True, fddb_detect_method=method,
        left_pupils=(0,), right_pupils=(1,), fddb_dir=str(fddb_dir),
    )


@pytest.fixture(scope="module")
def fddb(tmp_path_factory):
    """FDDB folder (4 VGA JPEGs of fold 1), and one model in both
    packages."""
    d = tmp_path_factory.mktemp("fddb")
    os.makedirs(d / "FDDB-folds")
    os.makedirs(d / "images" / "synth" / "fold_01")
    for name in NAMES:
        shutil.copy(os.path.join(SRC, "images", name + ".jpg"),
                    d / "images" / (name + ".jpg"))
    (d / "FDDB-folds" / "FDDB-fold-01.txt").write_text("\n".join(NAMES) + "\n")
    shutil.copy(os.path.join(SRC, "FDDB-folds", "FDDB-fold-01-ellipseList.txt"),
                d / "FDDB-folds")
    m = JP.synthetic_model(T=2, K=24, landmark_n=5, tree_depth=4, seed=11,
                           drop_profile=DROP)
    return d, m, TP.from_arrays(dataclasses.asdict(m))


@pytest.mark.parametrize("method", [1, 0])
def test_run_fddb_matches_jax(fddb, method):
    d, m, tm = fddb
    want = j_run_fddb(m, JConfig(**_cfg(d, method)), folds=[1],
                      out_dir=str(d / f"jax{method}"))
    got = run_fddb(tm, Config(**_cfg(d, method)), folds=[1],
                   out_dir=str(d / f"port{method}"), device="cpu")
    a = (d / f"jax{method}" / "fold-01-out.txt").read_bytes()
    b = (d / f"port{method}" / "fold-01-out.txt").read_bytes()
    assert a == b
    assert {k: want[k] for k in COUNTS} == {k: got[k] for k in COUNTS}
    assert got["images"] == 4 and got["folds"][0]["images"] == 4
    lines = b.decode().splitlines()
    assert lines[0] == NAMES[0] and sum(int(lines[i]) for i in _count_lines(lines)) > 0


def _count_lines(lines):
    """Indices of the detection-count lines of a fold file."""
    i, out = 0, []
    while i < len(lines):
        out.append(i + 1)
        i += 2 + int(lines[i + 1])
    return out


def test_imread_seam_and_annotation(fddb, monkeypatch):
    """A reader passed as imread= replaces OpenCV's: the same fold file,
    a file it cannot read skipped; annotation draws on the images; without
    OpenCV the default reader raises and names imread=."""
    cv2 = pytest.importorskip("cv2")
    d, _, tm = fddb
    c = Config(**_cfg(d, 1))
    default = run_fddb(tm, c, folds=[1], out_dir=str(d / "default"), device="cpu")

    read = []

    def imread(path):
        read.append(path)
        if path.endswith("img_003.jpg"):
            return None
        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)

    got = run_fddb(tm, c, folds=[1], out_dir=str(d / "seam"), imread=imread,
                   annotate=True, device="cpu")
    assert len(read) == 4 and got["images"] == 3
    want = (d / "default" / "fold-01-out.txt").read_text().splitlines()
    seam = (d / "seam" / "fold-01-out.txt").read_text().splitlines()
    assert NAMES[3] in want and NAMES[3] not in seam and seam == want[: len(seam)]
    assert len([f for f in os.listdir(d / "seam") if f.endswith(".jpg")]) == 3
    assert default["images"] == 4

    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 now fails
    with pytest.raises(ImportError, match="imread="):
        run_fddb(tm, c, folds=[1], out_dir=str(d / "none"), device="cpu")
    with pytest.raises(ImportError, match="annotate"):
        run_fddb(tm, c, folds=[1], out_dir=str(d / "none"), imread=imread,
                 annotate=True, device="cpu")


def test_read_fold_and_ellipses():
    assert read_fold(SRC, 1)[:4] == NAMES
    gt = read_ellipses(SRC, 1)
    assert gt[NAMES[0]].shape == (2, 6) and gt[NAMES[1]].shape == (3, 6)
