"""scripts/synth_fddb_torch.py against scripts/synth_fddb.py on the CPU:
the tree it builds is the in-tree data/fddb_synth's (lists and JPEG
bytes), its scoring equals the JAX script's on the in-tree results, and a
run held against another tree counts its mismatches."""

import os
import shutil
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scripts import synth_fddb as J  # noqa: E402
from scripts import synth_fddb_torch as S  # noqa: E402
from torch_train_util import one_torch_thread  # noqa: E402,F401 (autouse)

SRC = os.path.join(ROOT, "data", "fddb_synth")


def test_build_tree_is_the_in_tree_prefix(tmp_path):
    """One fold of 4 scenes: the fold and ellipse lists are prefixes of the
    in-tree files and the JPEGs are byte-equal to the in-tree ones."""
    S.build_tree(str(tmp_path), 1, 4)
    for name in ("FDDB-fold-01.txt", "FDDB-fold-01-ellipseList.txt"):
        got = (tmp_path / "FDDB-folds" / name).read_text()
        with open(os.path.join(SRC, "FDDB-folds", name)) as f:
            assert f.read().startswith(got) and got.count("synth/") == 4, name
    for i in range(4):
        rel = os.path.join("images", "synth", "fold_01", f"img_{i:03d}.jpg")
        with open(os.path.join(SRC, rel), "rb") as f:
            assert (tmp_path / rel).read_bytes() == f.read(), rel


def test_score_outputs_match_the_jax_script():
    """Faces and the whole discROC curve on the in-tree results equal the
    JAX script's, and so do the headline points."""
    got = S.score_outputs(SRC, 2)
    want = J.score_outputs(SRC, 2)
    assert got == want and got[0] == 101
    assert S.score_outputs(SRC, 2, os.path.join(SRC, "result")) == want
    pts = S.disc_roc_points(got[1], 24)
    assert list(pts) == ["recall@fp<=0", "recall@fp<=6", "recall@fp<=24", "recall@fp<=96"]


def test_compare_run_counts_mismatches(tmp_path):
    """A copy of the in-tree tree against itself has no mismatch; moved
    rects, scores past 2e-4, printed digits and a list that differs are
    each counted."""
    for sub in ("FDDB-folds", "result"):
        shutil.copytree(os.path.join(SRC, sub), tmp_path / sub)
    out = str(tmp_path / "result")
    report, bad = S.compare_run(str(tmp_path), out, 2, SRC)
    assert bad == 0 and report["fold_out"][1]["detections"] > 0
    path = tmp_path / "result" / "fold-01-out.txt"
    lines = path.read_text().splitlines()
    dets = [i for i, ln in enumerate(lines) if len(ln.split()) == 5]
    x, y, w, h, s = lines[dets[0]].split()
    lines[dets[0]] = f"{int(x) + 1} {y} {w} {h} {s}"
    x, y, w, h, s = lines[dets[1]].split()
    lines[dets[1]] = f"{x} {y} {w} {h} {float(s) + 1e-3:.6f}"
    x, y, w, h, s = lines[dets[2]].split()
    lines[dets[2]] = f"{x} {y} {w} {h} {float(s) + 1e-4:.6f}"
    path.write_text("\n".join(lines) + "\n")
    with open(tmp_path / "FDDB-folds" / "FDDB-fold-02.txt", "a") as f:
        f.write("synth/fold_02/extra\n")
    report, bad = S.compare_run(str(tmp_path), out, 2, SRC)
    r = report["fold_out"][1]
    assert (r["differ"], r["scores_outside"], r["printed_differently"]) == (1, 1, 2)
    assert report["lists_differ"] == ["FDDB-fold-02.txt"] and bad == 3


def test_tiny_main_on_the_cpu(tmp_path):
    """main() on one fold of 2 scenes with --device cpu: builds the tree,
    runs the harness through jpeg.imread_gray into <dir>/result_torch,
    writes the stats with the JAX script's keys, and exits non-zero with the
    count of mismatches against a tree it does not equal; it refuses to
    write the JAX package's stats."""
    d = tmp_path / "tree"
    out = tmp_path / "stats.json"
    args = [os.path.join(ROOT, "models", "flagship_synth.model"), "--dir", str(d),
            "--folds", "1", "--scenes", "2", "--device", "cpu", "--out-json", str(out)]
    payload = S.main(args)
    assert payload["faces"] == 5 and payload["harness"]["images"] == 2
    assert (d / "result_torch" / "fold-01-out.txt").exists()
    assert {"model", "dir", "faces", "harness", "disc_roc_points", "roc_tail"} <= set(payload)
    assert set(payload["host_seconds"]) == {"generate", "encode", "decode", "detect"}
    with pytest.raises(SystemExit, match="mismatches against"):
        S.main(args + ["--against", SRC])
    with pytest.raises(ValueError, match="JAX package"):
        S.main(args[:1] + ["--device", "cpu", "--out-json", S.JAX_RECORD])
    assert np.isfinite(payload["roc_tail"][2])
