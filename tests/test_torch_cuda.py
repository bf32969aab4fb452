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
