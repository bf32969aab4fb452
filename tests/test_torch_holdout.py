"""The held-out evaluation on the port (scripts/eval_holdout_torch.py)
against scripts/eval_holdout.py on the CPU: OpenCV's INTER_CUBIC resize
and float32 GaussianBlur as the port models them, the perturbations, the
texture scenes and chip_smoke.py's digests (the shipped model's
detections are in tests/test_torch_holdout_detect.py)."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

cv2 = pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
from jda_tpu_torch.ops.resize import (  # noqa: E402
    cubic_taps, cv2_gaussian_blur_f32, cv2_resize_cubic, gaussian_kernel_f32)
from scripts import eval_holdout as J  # noqa: E402
from scripts import eval_holdout_torch as H  # noqa: E402
from scripts import eval_synth_scenes as JE  # noqa: E402
from torch_train_util import one_torch_thread  # noqa: E402,F401 (autouse)

# pixels of the 24 smooth-noise backgrounds (12x12 up to 640x480, the
# script's draws from seed 777 on) where cv2_resize_cubic is off OpenCV's
# IPP resize (ops/resize.cv2_resize_cubic)
CUBIC_RESIDUE = 0
# the same over three random images of each shape of test_resize_cubic_...
RANDOM_RESIDUE = 0
# the 24 texture_bg scenes: the same where the faces leave the background
# showing
TEXTURE_RESIDUE = 0

def _inner(src, dst):
    """Outputs whose taps lie inside the image in both axes."""
    _, _, xc = cubic_taps(dst[0], src[1])
    _, _, yc = cubic_taps(dst[1], src[0])
    return ~yc[:, None] & ~xc[None, :]


def _shapes():
    return [((12, 12), (640, 480)), ((37, 53), (100, 70)), ((100, 70), (37, 53)),
            ((480, 640), (333, 251)), ((13, 17), (641, 483)), ((30, 40), (29, 41)),
            ((16, 16), (5, 7)), ((9, 120), (200, 15))]


@pytest.mark.parametrize("src,dst", _shapes(), ids=lambda v: "x".join(map(str, v)))
def test_resize_cubic_matches_opencv(src, dst):
    """Up and down, square and odd: every output whose taps lie inside the
    image is OpenCV's bit for bit; over three random images per shape at
    most RANDOM_RESIDUE others are not, each 1 off."""
    rng = np.random.default_rng(src[0] * 1000 + dst[0])
    inner = _inner(src, dst)
    n = 0
    for _ in range(3):
        img = rng.integers(0, 256, src).astype(np.uint8)
        want = cv2.resize(img, dst, interpolation=cv2.INTER_CUBIC)
        got = cv2_resize_cubic(img, *dst)
        assert got.dtype == np.uint8 and got.shape == want.shape
        diff = got.astype(int) - want
        assert np.abs(diff).max() <= 1 and not diff[inner].any()
        n += int(np.count_nonzero(diff))
    assert n <= RANDOM_RESIDUE, n


def test_resize_cubic_residue_on_the_scripts_backgrounds():
    """The 24 backgrounds of _smooth_noise: at most CUBIC_RESIDUE pixels
    differ, each by 1 and none among the inner outputs."""
    rng = np.random.default_rng(777)
    inner = _inner((12, 12), (640, 480))
    n = 0
    for _ in range(24):
        coarse = rng.integers(40, 215, (12, 12)).astype(np.uint8)
        want = cv2.resize(coarse, (640, 480), interpolation=cv2.INTER_CUBIC)
        got = cv2_resize_cubic(coarse, 640, 480)
        diff = got.astype(int) - want
        assert np.abs(diff).max() <= 1 and not diff[inner].any()
        n += int(np.count_nonzero(diff))
    assert n <= CUBIC_RESIDUE, n


@pytest.mark.parametrize("src,dst", [
    ((3, 20), (60, 50)), ((20, 3), (60, 50)), ((2, 2), (10, 10)), ((1, 40), (97, 1)),
    ((3, 3), (40, 3)), ((5, 2), (53, 5)), ((2, 40), (124, 2)), ((48, 46), (3, 48)),
    ((30, 40), (73, 30)), ((64, 64), (64, 64))], ids=lambda v: "x".join(map(str, v)))
def test_resize_cubic_small_sources_and_same_height(src, dst):
    """Sources with a side under 4 (OpenCV's own fixed-point resize, not
    IPP's) and outputs as tall as their source: OpenCV's answer on every
    pixel of three random images."""
    rng = np.random.default_rng(src[0] * 1000 + src[1] * 10 + dst[0])
    for _ in range(3):
        img = rng.integers(0, 256, src).astype(np.uint8)
        want = cv2.resize(img, dst, interpolation=cv2.INTER_CUBIC)
        got = cv2_resize_cubic(img, *dst)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("sigma", [1.0, 1.37, 1.8])
def test_gaussian_blur_f32_matches_opencv(sigma):
    """Bit-equal to cv2.GaussianBlur on float32 scenes and odd shapes (the
    vector loops' tails), kernels of 9-15 taps."""
    assert len(gaussian_kernel_f32(sigma)) == (int(np.rint(sigma * 8 + 1)) | 1)
    rng = np.random.default_rng(int(sigma * 100))
    for shape in [(480, 640), (37, 53), (30, 47), (20, 9)]:
        img = rng.integers(0, 256, shape).astype(np.float32)
        want = cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)
        got = cv2_gaussian_blur_f32(img, sigma)
        assert got.dtype == np.float32 and np.array_equal(got, want), shape
    with pytest.raises(ValueError):
        cv2_gaussian_blur_f32(img.astype(np.float64), sigma)


@pytest.mark.parametrize("family", ["photometric", "blur", "occlusion", "gradient", "base"])
def test_perturb_matches_the_jax_script(family):
    """perturb equals scripts/eval_holdout.perturb under the same
    default_rng(seed), and leaves the stream alike."""
    scenes, gt = JE.build_scenes(np.random.default_rng(777), 6)
    for seed in (0, 5):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        for s, (boxes, _) in zip(scenes, gt):
            a = J.perturb(ra, s, boxes, family)
            b = H.perturb(rb, s, boxes, family)
            assert a.dtype == b.dtype == np.uint8 and np.array_equal(a, b), (family, seed)
        assert ra.integers(1 << 62) == rb.integers(1 << 62)


def test_texture_scenes_match_the_jax_script():
    """build_texture_scenes: the truths equal, the scenes equal but for the
    resize residue on the background; over all 24 scenes at most
    TEXTURE_RESIDUE pixels, each 1 off."""
    a, ga = J.build_texture_scenes(np.random.default_rng(778), 24)
    b, gb = H.build_texture_scenes(np.random.default_rng(778), 24)
    for (ba, la), (bb, lb) in zip(ga, gb):
        assert ba == bb and all(np.array_equal(x, y) for x, y in zip(la, lb))
    diffs = [np.abs(x.astype(int) - y) for x, y in zip(a, b)]
    assert max(int(d.max()) for d in diffs) <= 1
    assert sum(int(np.count_nonzero(d)) for d in diffs) <= TEXTURE_RESIDUE
    assert np.array_equal(a[1], b[1])


def test_chip_smoke_digests_are_the_jax_scripts():
    """Phase 23's constants: the JAX script's families with OpenCV and the
    port's families both give HOLDOUT_DIGESTS."""
    base, bgt = JE.build_scenes(np.random.default_rng(777), 24)
    fams = {"base": (base, bgt)}
    for fam in H.PERTURBED:
        rng = np.random.default_rng(chip_smoke.HOLDOUT_SEEDS[fam])
        fams[fam] = ([J.perturb(rng, s, g, fam) for s, (g, _) in zip(base, bgt)], bgt)
    fams["texture_bg"] = J.build_texture_scenes(np.random.default_rng(778), 24)
    assert chip_smoke.holdout_digests(fams) == chip_smoke.HOLDOUT_DIGESTS
    port = chip_smoke.holdout_digests(H.build_families(24, chip_smoke.HOLDOUT_SEEDS))
    assert port == chip_smoke.HOLDOUT_DIGESTS
