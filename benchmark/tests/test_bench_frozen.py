"""The frozen generators and model readers equal the repository's own."""

import json
import os

import numpy as np
import pytest

import bench_torch
import chip_smoke
from benchmark import frozen as F
from benchmark import harness as H
from benchmark import yardstick as Y
from jda_tpu_torch import params as P

ROOT = H.ROOT


@pytest.mark.parametrize("h,w,seed", [(48, 64, 3), (37, 53, 31), (24, 40, 2**31 + 5)])
def test_make_image(h, w, seed):
    assert np.array_equal(F.make_image(h, w, seed), bench_torch.make_image(h, w, seed))


@pytest.mark.parametrize("seed,faces", [(200, 3), (4096 * 77 + 5, 2)])
def test_make_scene(seed, faces):
    got, boxes = F.make_scene(240, 320, seed, faces)
    want, want_boxes = chip_smoke.make_scene(240, 320, seed, faces)
    assert np.array_equal(got, want) and boxes == want_boxes
    assert np.array_equal(F.FACE27, chip_smoke.FACE27)


@pytest.mark.parametrize("T,K,seed", [(2, 40, 0), (3, 24, 7), (1, 80, 11)])
def test_synthetic_model(T, K, seed):
    want = P.synthetic_model(T=T, K=K, landmark_n=27, seed=seed,
                             drop_profile=P.realistic_drop_profile(T, K))
    got = F.synthetic_model(T, K, 27, 4, seed)
    assert np.array_equal(F.realistic_drop_profile(T, K), P.realistic_drop_profile(T, K))
    for k in F.FIELDS:
        assert np.array_equal(got[k], getattr(want, k)), k


def test_stored_thresholds_are_the_calibrated_ones():
    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/jda_t5k540_synth.json")))
    m = H.model_fields(cfg)
    want = F.calibrate_thresholds(m["leaf_scores"], F.realistic_drop_profile(5, 540), 7)
    assert np.array_equal(m["cart_th"], want)


def test_flagship_file_reader():
    cfg = json.load(open(os.path.join(ROOT, "benchmark/configs/jda_flagship_synth.json")))
    got = H.model_fields(cfg)
    want = P.load_model(os.path.join(ROOT, cfg["model"]["path"]))
    for k in F.FIELDS:
        assert np.array_equal(got[k], getattr(want, k)), k
    with pytest.raises(ValueError, match="sha256"):
        H.model_fields(dict(cfg, model=dict(cfg["model"], sha256="0" * 64)))


@pytest.mark.parametrize("B,H_,W_,nvis,lbf", [(16, 480, 640, 65_000_000, 300_000), (1, 1080, 1920, 3, 0)])
def test_ladder_bound(B, H_, W_, nvis, lbf):
    want = chip_smoke.ladder_bound(B, H_, W_, 14, 169706, 540, 7, nvis, 4, lbf_bytes=lbf)
    got = Y.ladder_bound(B, H_, W_, 14, 169706, 540, 7, nvis, 4, lbf_bytes=lbf)
    assert got[0] * 1e3 == pytest.approx(want[0], rel=1e-12)
    assert got[1] * 1e3 == pytest.approx(want[1], rel=1e-12)
    assert Y.lbf_words(540) == 68
