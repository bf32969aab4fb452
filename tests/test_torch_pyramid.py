"""The multi-scale detector's o/h/q pyramid (ops/pyramid.py) on the CPU.

`layout` and the detector's pyramid step (`Detector._pyramid`, through
`fill_levels` and its plain PyTorch twin) are held to the JAX package's
host pyramid, `stack_pyramid(pyramid_c(gray))` (numpy; no JAX compile),
bit for bit over odd and even sizes up to 1080p (the port's copy of it,
the card tests' yardstick, is held to it in tests/test_torch_resize.py);
the detector's multi-scale route builds every image's levels through
`fill_levels`.  The kernel itself is held to the same on a card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import jda_tpu_torch as jt
from jda_tpu.ops import resize as JR
from jda_tpu_torch import tracing
from jda_tpu_torch.ops import pyramid as PY
from jda_tpu_torch.ops import resize as R

# square, odd widths and heights, the detector tests' ladders, VGA (whose q
# ratio 479/240 rounds apart from 479 * (1/240)) and 1080p (an odd h width)
SWEEP = [(24, 24), (25, 37), (37, 25), (31, 53), (60, 80), (72, 56), (480, 640),
         (1080, 1920)]
IDS = ["x".join(map(str, hw)) for hw in SWEEP]


def _img(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.uint8)


@pytest.mark.parametrize("hw", SWEEP, ids=IDS)
def test_layout_is_the_stacked_host_pyramid(hw):
    """F, offsets and strides from the size alone equal the stacked host
    levels' length, offsets and strides, dtypes included."""
    want_flat, want_offsets, want_strides = JR.stack_pyramid(JR.pyramid_c(_img(*hw, 1)))
    lay = PY.layout(*hw)
    assert lay.F == want_flat.shape[0]
    for got, want in ((lay.offsets, want_offsets), (lay.strides, want_strides)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("hw", SWEEP, ids=IDS)
def test_plain_pyramid_is_pyramid_c(hw):
    """The detector's pyramid step on the CPU (the plain twin) builds the
    host pyramid's bytes, every one of them, and its offsets and strides."""
    img = _img(*hw, hw[0] + hw[1])
    want, offsets, strides = JR.stack_pyramid(JR.pyramid_c(img))
    det = jt.Detector(jt.synthetic_model(T=1, K=8, landmark_n=9, seed=3, multi_scale=True),
                      device="cpu")
    flat, got_offsets, got_strides = det._pyramid(img, {})
    assert flat.dtype == torch.uint8 and flat.shape == want.shape
    assert np.array_equal(flat.numpy(), want)
    assert np.array_equal(got_offsets, offsets) and np.array_equal(got_strides, strides)



def test_q_ratio_is_a_true_division():
    """The VGA q level's row ratio is the C library's float32 479 / 240,
    which a multiply by the reciprocal misses."""
    (_, _), (_, qy) = PY.layout(480, 640).ratios
    assert qy == np.float32(479) / np.float32(240)
    assert qy != np.float32(479) * (np.float32(1) / np.float32(240))


def test_wrappers_check_their_inputs():
    lay = PY.layout(24, 30)
    flat = torch.zeros(lay.F, dtype=torch.uint8)
    for bad, what in ((flat.float(), "uint8"), (flat[None], "uint8"),
                      (torch.zeros(2 * lay.F, dtype=torch.uint8)[::2], "contiguous"),
                      (flat[1:], "bytes")):
        with pytest.raises(ValueError, match=what):
            PY.fill_levels(bad, lay)


def test_multi_scale_detector_builds_levels_through_fill_levels(monkeypatch):
    """Every image of a multi-scale model on the non-fused path gets its
    levels from `fill_levels`, in a buffer of exactly the plan's layout,
    under one `pyramid` span an image; a single-scale model's non-fused
    path keeps its trivial 1x1 levels and never calls it."""
    seen = []
    fill = PY.fill_levels
    monkeypatch.setattr(PY, "fill_levels",
                        lambda flat, lay: seen.append((flat.shape[0], lay)) or fill(flat, lay))
    m = jt.synthetic_model(T=2, K=8, landmark_n=9, seed=3, multi_scale=True, reject_rate=0.3)
    det = jt.Detector(m, device="cpu")
    imgs = [_img(60, 80, 5), _img(60, 80, 6), _img(72, 56, 7)]
    tracing.start()
    try:
        det.detect_stream(imgs, batch=2, th=-5.0)
    finally:
        tracing.stop()
    spans, _ = tracing.drain()
    assert [F for F, _ in seen] == [PY.layout(*g.shape).F for g in imgs]
    assert [s.name for s in spans].count("pyramid") == len(imgs)
    plans = [p for p in det._plans.values() if "pyramid" in p]
    assert sorted((p["Hc"], p["Wc"]) for p in plans) == [(60, 80), (72, 56)]
    for p in plans:
        want = PY.layout(p["Hc"], p["Wc"])
        assert p["pyramid"].F == want.F and np.array_equal(p["pyramid"].offsets, want.offsets)
    seen.clear()
    monkeypatch.setenv("JDA_TPU_FUSED", "0")
    single = jt.Detector(jt.synthetic_model(T=2, K=8, landmark_n=9, seed=3, reject_rate=0.3),
                         device="cpu")
    single.detect(imgs[0], th=-5.0)
    assert not seen
