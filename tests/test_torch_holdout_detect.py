"""The shipped model on the held-out families (scripts/eval_holdout_torch.
py), the port on the CPU against jda_tpu on the CPU: the first scene of
each family of build_families(n, chip_smoke.HOLDOUT_SEEDS) gives the
detections and the sweep that jda_tpu gives."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import jda_tpu_torch  # noqa: E402
from scripts import eval_holdout_torch as H  # noqa: E402

# jda_tpu.Detector(m, rounding=True).detect_stream(batch=8, th=-3,
# scale=1.25) on the CPU over the first scene of each family: the SHA-256
# of its result (bboxes, scores, shapes) and (tp, fp) at each threshold of
# the sweep.  Recorded once from the JAX package (over two scenes of each
# family, the first scene's part taken): its CPU compile of that plan
# takes minutes
JAX_FIRST_SCENES = {
    "base": {"sha256": "cab2332793c170651a7e9716fdb5175d2c94380679f37b88a148bc85dcb58dda",
             "tp_fp": [[2, 0], [2, 0], [2, 0], [2, 0], [1, 0], [1, 0], [1, 0], [1, 0], [0, 0], [0, 0]]},
    "photometric": {"sha256": "437aac5919b84de27bb798e17f929eb3da802887c41bfe1412d8bf3f6c53a940",
                    "tp_fp": [[2, 0], [2, 0], [2, 0], [2, 0], [1, 0], [1, 0], [1, 0], [1, 0], [0, 0], [0, 0]]},
    "blur": {"sha256": "61529daf829a74b2bf7bec0abff633a7f27be30fb065148e3cb40cb022148738",
             "tp_fp": [[1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [1, 0], [0, 0], [0, 0]]},
    "occlusion": {"sha256": "be08c4ed11a343885aed8115eb6172d778a6cff4e28174ca3f60c632a45fe979",
                  "tp_fp": [[0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0], [0, 0]]},
    "gradient": {"sha256": "70bbb76766251a3d464d9a5deb0c3c8c53f106aa3b6436289c0a3d5353c4a0b4",
                 "tp_fp": [[2, 0], [2, 0], [2, 0], [2, 0], [1, 0], [1, 0], [1, 0], [1, 0], [0, 0], [0, 0]]},
    "texture_bg": {"sha256": "8d6fc5b02338aecae4b3ffb5b50444385a597596090256bc2887645fc82b3e6d",
                   "tp_fp": [[2, 0], [2, 0], [2, 0], [2, 0], [2, 0], [2, 0], [1, 0], [1, 0], [0, 0], [0, 0]]},
}


@pytest.fixture
def four_torch_threads():
    """The plain stage-0 filter is the CPU's cost here (about 25 s a VGA
    scene on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def test_first_scene_of_each_family_against_jda_tpu(four_torch_threads):
    families = H.build_families(1, chip_smoke.HOLDOUT_SEEDS)
    model = jda_tpu_torch.load_model(os.path.join(ROOT, "models", "flagship_synth.model"))
    det = jda_tpu_torch.Detector(model, rounding=True, device="cpu")
    scenes = [families[f][0][0] for f in H.FAMILIES]
    res = det.detect_stream(scenes, batch=8, th=-3.0, scale=1.25)  # one batch of six
    for fam, r in zip(H.FAMILIES, res):
        sha = chip_smoke._sha256([np.asarray(r.bboxes), np.asarray(r.scores), np.asarray(r.shapes)])
        assert sha == JAX_FIRST_SCENES[fam]["sha256"], fam
        pts = H.sweep([r], families[fam][1])
        assert [[p["tp"], p["fp"]] for p in pts] == JAX_FIRST_SCENES[fam]["tp_fp"], fam
