"""jda_tpu_torch.ops.resize and window_geometry against the JAX package's.

Both are numpy on the host and the port keeps its own copy, so every
function is held bit-equal (no tolerance) on random uint8 images of odd and
even sizes."""

import numpy as np
import pytest

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
