"""jda_tpu_torch on a CUDA card: the kernels against their plain versions
and the detector against its own CPU path.

These tests need a card and nvcc (marker `cuda`) and import no JAX, so they
run where the port runs:

    python -m pytest tests/test_torch_cuda.py -q

Everything here is bit-exact: the kernel's float ops are IEEE
round-to-nearest in the plain version's order, and the survivor tail runs
the same PyTorch ops on both devices.
"""

import numpy as np
import pytest
import torch

import jda_tpu_torch as jt
from jda_tpu_torch.detect import enumerate_windows
from jda_tpu_torch.ops import _build
from jda_tpu_torch.ops import dense0 as D0

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _tables(det, win, step, device):
    tabi, tabf = D0.pack_tables(
        D0.node_tables(det._ms32, det._host_stage0, win, step), det.params.node_n
    )
    return torch.from_numpy(tabi).to(device), torch.from_numpy(tabf).to(device)


@pytest.fixture
def cpu_det():
    m = jt.synthetic_model(T=3, K=21, landmark_n=9, seed=4, reject_rate=0.2)
    return jt.Detector(m, device="cpu")


def test_wrapper_raises_when_build_missing(cuda, cpu_det, monkeypatch):
    tabi, tabf = _tables(cpu_det, 24, 2, cuda)
    monkeypatch.setattr(_build, "CSRC", "/nonexistent-csrc")
    monkeypatch.setattr(_build, "_libs", {})
    img = torch.zeros((1, 40, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="kernel source missing"):
        D0.scale_filter(img, tabi, tabf, step=2, ny=9, nx=9, depth=4)


@pytest.mark.parametrize("emit_lbf", [False, True], ids=["nolbf", "lbf"])
@pytest.mark.parametrize("win", [24, 57, 110])
def test_kernel_matches_plain(cuda, cpu_det, win, emit_lbf):
    H, W = 160, 300
    step = max(int(np.float32(win) * np.float32(0.1)), 1)
    ny, nx = (H - win) // step + 1, (W - win) // step + 1
    img = torch.from_numpy(np.stack([_img(H, W, s) for s in range(3)])).to(cuda)
    tabi, tabf = _tables(cpu_det, win, step, cuda)
    kw = dict(step=step, ny=ny, nx=nx, depth=4, emit_lbf=emit_lbf)
    before = D0.scale_filter.launches
    got = D0.scale_filter(img, tabi, tabf, **kw)
    want = D0.scale_filter_reference(img, tabi, tabf, **kw)
    torch.cuda.synchronize()
    assert D0.scale_filter.launches == before + 1
    alive = want[1]
    assert 0 < int(alive.sum()) < alive.numel(), "degenerate fixture"
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    if emit_lbf:
        assert torch.equal(got[3][alive], want[3][alive])


def test_wrapper_rejects_bad_inputs(cuda, cpu_det):
    tabi, tabf = _tables(cpu_det, 24, 2, cuda)
    img = torch.zeros((1, 40, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="uint8"):
        D0.scale_filter(img.float(), tabi, tabf, step=2, ny=9, nx=9, depth=4)
    with pytest.raises(ValueError, match="outside the image"):
        D0.scale_filter(img, tabi, tabf, step=2, ny=12, nx=9, depth=4)
    with pytest.raises(ValueError, match="one device"):
        D0.scale_filter(img, tabi.cpu(), tabf, step=2, ny=9, nx=9, depth=4)


def test_detector_on_card_matches_cpu(cuda, cpu_det):
    grays = [_img(96, 128, 1), _img(80, 112, 2), _img(96, 100, 3)]
    gdet = jt.Detector(cpu_det.params)
    assert gdet.device.type == "cuda"
    want = cpu_det.detect_batch(grays, th=-5.0)
    got = gdet.detect_stream(grays, batch=2, th=-5.0)
    assert sum(r.n for r in want) > 0, "degenerate fixture"
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.shapes, b.shapes)


def _ladder(det, H, W, device):
    x, _, _, scales = enumerate_windows(W, H, 1.25, 24, min(H, W))
    return len(x), scales, [_tables(det, w, s, device) for w, s, _, _ in scales]


def test_image_kernel_matches_plain_and_batch_kernel(cuda, cpu_det):
    """`dense0_image` on a small ladder: one launch, bit-equal to its plain
    version and to `dense0_filter` at B=1 concatenated."""
    H, W = 150, 210
    n, scales, tabs = _ladder(cpu_det, H, W, cuda)
    assert len(scales) >= 8
    img = torch.from_numpy(_img(H, W, 5)).to(cuda)
    before = D0.stage0_filter_image.launches
    got = D0.stage0_filter_image(img, tabs, meta=scales, depth=4)
    torch.cuda.synchronize()
    assert D0.stage0_filter_image.launches == before + 1
    want = D0.stage0_filter_image_reference(img, tabs, meta=scales, depth=4)
    per_scale = D0.stage0_filter_all_scales(img[None], tabs, meta=scales, depth=4)
    assert 0 < int(want[1].sum()) < n, "degenerate fixture"
    for a, b, c in zip(got, want, per_scale):
        assert a.shape == (n,) and a.dtype == b.dtype
        assert torch.equal(a, b)
        assert torch.equal(a, c[0])
    # prepared tables of this geometry are taken as they are, others refused
    prepared = D0.prepare_image(tabs, meta=scales, depth=4, H=H, W=W)
    again = D0.stage0_filter_image(img, tabs, meta=scales, depth=4, prepared=prepared)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    with pytest.raises(ValueError, match="another geometry"):
        D0.stage0_filter_image(img[:-1].contiguous(), tabs, meta=scales, depth=4,
                               prepared=prepared)
    with pytest.raises(ValueError, match="uint8"):
        D0.stage0_filter_image(img.float(), tabs, meta=scales, depth=4)


def test_image_wrapper_raises_when_build_missing(cuda, cpu_det, monkeypatch):
    n, scales, tabs = _ladder(cpu_det, 40, 40, cuda)
    monkeypatch.setattr(_build, "CSRC", "/nonexistent-csrc")
    monkeypatch.setattr(_build, "_libs", {})
    img = torch.zeros((40, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="kernel source missing"):
        D0.stage0_filter_image(img, tabs, meta=scales, depth=4)


@pytest.mark.parametrize("rounding", [False, True], ids=["trunc", "round"])
def test_unfused_detector_on_card_matches_cpu(cuda, cpu_det, monkeypatch, rounding):
    """JDA_TPU_FUSED=0 on the card: one `dense0_image` launch per image,
    results bit-equal to the CPU port's and to the card's fused path."""
    grays = [_img(96, 128, 1), _img(80, 112, 2)]
    gdet = jt.Detector(cpu_det.params, rounding=rounding)
    cdet = jt.Detector(cpu_det.params, rounding=rounding, device="cpu")
    fused = gdet.detect_batch(grays, th=-5.0)
    monkeypatch.setenv("JDA_TPU_FUSED", "0")
    before = D0.stage0_filter_image.launches
    got = gdet.detect_batch(grays, th=-5.0)
    assert D0.stage0_filter_image.launches == before + len(grays)
    want = cdet.detect_batch(grays, th=-5.0)
    assert sum(r.n for r in want) > 0, "degenerate fixture"
    for a, b, c in zip(want, got, fused):
        for f in ("bboxes", "scores", "shapes"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(c, f), getattr(b, f))


def test_multi_scale_detector_on_card_matches_cpu(cuda):
    """A multi-scale model (pyramid, prefilter, stage loop of _run_batch)
    on the card, bit-equal to the CPU port on the full ladder."""
    m = jt.synthetic_model(T=3, K=24, landmark_n=9, seed=14, multi_scale=True,
                           reject_rate=0.1)
    img = _img(96, 128, 15)
    want = jt.Detector(m, prefilter_carts=8, device="cpu").detect(img, th=-5.0)
    got = jt.Detector(m, prefilter_carts=8).detect(img, th=-5.0)
    assert want.n > 0, "degenerate fixture"
    np.testing.assert_array_equal(want.bboxes, got.bboxes)
    np.testing.assert_array_equal(want.scores, got.scores)
    np.testing.assert_array_equal(want.shapes, got.shapes)
