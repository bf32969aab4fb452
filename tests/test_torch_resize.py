"""jda_tpu_torch.ops.resize and window_geometry against the JAX package's.

Both are numpy on the host and the port keeps its own copy, so every
function is held bit-equal (no tolerance) on random uint8 images of odd and
even sizes.  `cv2_resize`, the port's own model of cv2.resize, is held
bit-equal to the installed OpenCV (skipped without it)."""

import math

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from jda_tpu.detect import enumerate_windows as j_enumerate_windows
from jda_tpu.detect import window_geometry as j_window_geometry
from jda_tpu.ops import resize as JR
from jda_tpu_torch.detect import enumerate_windows, window_geometry
from jda_tpu_torch.ops import resize as TR

# (src_h, src_w, dst_w, dst_h): odd and even, shrinking and growing
SIZES = [(64, 96, 48, 32), (57, 83, 41, 29), (96, 128, 90, 67), (33, 47, 60, 50)]


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)


@pytest.mark.parametrize(
    "fn", ["resize_bilinear_c", "resize_bilinear_cv", "resize_bilinear_cv_exact"]
)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "x".join(map(str, s)))
def test_resize_bit_equal(fn, size):
    h, w, dw, dh = size
    img = _img(h, w, h + w)
    a = getattr(JR, fn)(img, dw, dh)
    b = getattr(TR, fn)(img, dw, dh)
    assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape == (dh, dw)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(64, 96), (57, 83), (120, 161)])
def test_pyramid_and_stack_bit_equal(hw):
    img = _img(*hw, seed=7)
    jp, tp = JR.pyramid_c(img), TR.pyramid_c(img)
    assert len(jp) == len(tp) == 3
    for a, b in zip(jp, tp):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    for a, b in zip(JR.stack_pyramid(jp), TR.stack_pyramid(tp)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_cv_fixed_point_helpers_equal():
    for src_n, dst_n in ((96, 48), (83, 41), (47, 60)):
        for a, b in zip(JR.cv_linear_taps_fixed(src_n, dst_n),
                        TR.cv_linear_taps_fixed(src_n, dst_n)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    t0, t1 = rng.integers(0, 255 * 2048, (2, 50)).astype(np.int32)
    b0 = rng.integers(0, 2049, 50).astype(np.int32)
    np.testing.assert_array_equal(
        JR.cv_fixed_combine(t0, t1, b0, 2048 - b0),
        TR.cv_fixed_combine(t0, t1, b0, 2048 - b0),
    )


@pytest.mark.parametrize("hw", [(96, 128), (71, 103)])
def test_window_geometry_bit_equal_on_full_ladder(hw):
    H, W = hw
    img = _img(H, W, seed=1)
    _, offsets, strides = TR.stack_pyramid(TR.pyramid_c(img))
    jw = j_enumerate_windows(W, H, 1.25, 24, min(H, W))
    tw = enumerate_windows(W, H, 1.25, 24, min(H, W))
    assert len(tw[0]) > 1000 and len(tw[3]) >= 5
    for a, b in zip(jw[:3], tw[:3]):
        np.testing.assert_array_equal(a, b)
    assert jw[3] == tw[3]
    jg = j_window_geometry(*jw[:3], offsets, strides)
    tg = window_geometry(*tw[:3], offsets, strides)
    assert set(jg) == set(tg) == {"base", "stride", "pw", "ph"}
    for k in jg:
        assert jg[k].dtype == tg[k].dtype and jg[k].shape == tg[k].shape, k
        np.testing.assert_array_equal(jg[k], tg[k], err_msg=k)


# -- cv2_resize: the port's model of cv2.resize, held against OpenCV itself --


def _cv2():
    return pytest.importorskip("cv2")


@pytest.mark.parametrize("hw", [(480, 640), (512, 640), (1080, 1920)])
def test_cv2_resize_exact_on_shrink_chains(hw):
    """The method-0 pyramid chain at 1/1.3 (each level a resize of the one
    before, down to 20 px) and the method-1 planes at 1/sqrt(2) and 1/2:
    every pixel equal to OpenCV's, where resize_bilinear_cv_exact is not."""
    cv2 = _cv2()
    H, W = hw
    img = _img(H, W, seed=H)
    level, levels = img, 0
    while min(level.shape) >= 20:
        nw, nh = int(level.shape[1] / 1.3), int(level.shape[0] / 1.3)
        want = cv2.resize(level, (nw, nh))
        np.testing.assert_array_equal(TR.cv2_resize(level, nw, nh), want)
        level, levels = want, levels + 1
    assert levels >= 8
    for w, h in ((int(W / math.sqrt(2)), int(H / math.sqrt(2))), (W // 2, H // 2)):
        want = cv2.resize(img, (w, h))
        got = TR.cv2_resize(img, w, h)
        assert got.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, want)
    w, h = int(W / math.sqrt(2)), int(H / math.sqrt(2))
    assert (TR.resize_bilinear_cv_exact(img, w, h) != cv2.resize(img, (w, h))).any()


@pytest.mark.parametrize("d", [48, 36, 24])
def test_cv2_resize_exact_on_patches(d):
    """48 -> 48/36/24, the method-0 patch shapes, one patch and a stack of
    them in one call."""
    cv2 = _cv2()
    rois = np.stack([_img(48, 48, seed=s) for s in range(5)])
    stack = TR.cv2_resize(rois, d, d)
    assert stack.shape == (5, d, d)
    for roi, got in zip(rois, stack):
        np.testing.assert_array_equal(got, cv2.resize(roi, (d, d)))
        np.testing.assert_array_equal(TR.cv2_resize(roi, d, d), got)


@settings(max_examples=40, deadline=None, derandomize=True)
@given(
    h=st.integers(24, 1920),
    w=st.integers(24, 1920),
    ratio=st.floats(1.0, 2.5),
    seed=st.integers(0, 2**16),
)
def test_cv2_resize_exact_on_random_shrinks(h, w, ratio, seed):
    cv2 = _cv2()
    img = np.random.default_rng(seed).integers(0, 256, (h, w), dtype=np.uint8)
    dw, dh = max(1, int(w / ratio)), max(1, int(h / ratio))
    np.testing.assert_array_equal(TR.cv2_resize(img, dw, dh), cv2.resize(img, (dw, dh)))


def test_cv2_resize_rejects_bad_input():
    with pytest.raises(ValueError):
        TR.cv2_resize(np.zeros((8, 8), np.float32), 4, 4)
    with pytest.raises(ValueError):
        TR.cv2_resize(np.zeros((8, 8), np.uint8), 0, 4)
