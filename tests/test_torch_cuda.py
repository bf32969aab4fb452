"""jda_tpu_torch on a CUDA card: the kernels against their plain versions
and the detector against its own CPU path.

These tests need a card and nvcc (marker `cuda`) and import no JAX, so they
run where the port runs:

    python -m pytest tests/test_torch_cuda.py -q

Everything here is bit-exact: the kernel's float ops are IEEE
round-to-nearest in the plain version's order, and the survivor tail runs
the same PyTorch ops on both devices.
"""

import os

import numpy as np
import pytest
import torch

import jda_tpu_torch as jt
from jda_tpu_torch.detect import enumerate_windows
from jda_tpu_torch.ops import _build
from jda_tpu_torch.ops import dense0 as D0
from torch_walk import walk_reference

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
    assert D0.scale_filter.launches == before + 2  # head and survivor kernel
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
    """`dense0_image` on a small ladder: one call (head and survivor
    kernel), bit-equal to its plain version and to `dense0_filter` at B=1."""
    H, W = 150, 210
    n, scales, tabs = _ladder(cpu_det, H, W, cuda)
    assert len(scales) >= 8
    img = torch.from_numpy(_img(H, W, 5)).to(cuda)
    before = D0.stage0_filter_image.launches
    got = D0.stage0_filter_image(img, tabs, meta=scales, depth=4)
    torch.cuda.synchronize()
    assert D0.stage0_filter_image.launches == before + 2
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


@pytest.mark.parametrize("head_carts", [1, 8, 32, 96])
@pytest.mark.parametrize("emit_lbf", [False, True], ids=["nolbf", "lbf"])
def test_ladder_kernel_matches_plain(cuda, emit_lbf, head_carts):
    """The whole-ladder batch entry at B=2 on a small ladder: two kernels,
    flat outputs bit-equal to the plain filter scale by scale and to the
    plain walk on the prepared tables; leaf words equal where alive.  K=70
    is no multiple of 32 or 8, and the head lengths cover K < C."""
    det = jt.Detector(
        jt.synthetic_model(T=1, K=70, landmark_n=9, seed=7, reject_rate=0.1),
        device="cpu",
    )
    H, W = 150, 210
    n, scales, tabs = _ladder(det, H, W, cuda)
    img = torch.from_numpy(np.stack([_img(H, W, 7), _img(H, W, 8)])).to(cuda)
    prepared = D0.prepare_image(tabs, meta=scales, depth=4, H=H, W=W)
    before = D0.scale_filter.launches
    if head_carts == D0.HEAD_CARTS:
        got = D0.stage0_filter_all_scales(
            img, tabs, meta=scales, depth=4, emit_lbf=emit_lbf, prepared=prepared
        )
    else:
        got = (torch.empty((2, n), dtype=torch.float32, device=cuda),
               torch.empty((2, n), dtype=torch.bool, device=cuda),
               torch.empty((2, n), dtype=torch.int32, device=cuda))
        if emit_lbf:
            got += (torch.empty((2, n, D0.lbf_words(70)), dtype=torch.int32, device=cuda),)
        D0.launch(img, prepared, got, head_carts=head_carts)
    torch.cuda.synchronize()
    assert D0.scale_filter.launches == before + 2
    want = D0.stage0_filter_all_scales(
        img.cpu(), [(a.cpu(), b.cpu()) for a, b in tabs], meta=scales, depth=4,
        emit_lbf=True,
    )
    walk = walk_reference(img, prepared, emit_lbf=True)
    alive = want[1]
    assert got[0].shape == (2, n)
    assert 0 < int(alive.sum()) < alive.numel(), "degenerate fixture"
    for a, b, c in zip(got[:3], want[:3], walk[:3]):
        assert torch.equal(a.cpu(), b) and torch.equal(c.cpu(), b)
    assert torch.equal(walk[3].cpu(), want[3])
    if emit_lbf:
        assert torch.equal(got[3].cpu()[alive], want[3][alive])


def test_survivor_phase_alone(cuda):
    """The survivor kernel alone, from the plain walk's state at cart C and
    a queue of hand-picked windows: one that dies at cart C, one at cart
    K-1, one that dies in between and one that survives.  Their results
    equal the whole plain walk's; no other window is touched."""
    K, C = 70, 32
    det = jt.Detector(
        jt.synthetic_model(T=1, K=K, landmark_n=9, seed=7, reject_rate=0.1),
        device="cpu",
    )
    H, W = 150, 210
    n, scales, tabs = _ladder(det, H, W, cuda)
    img = torch.from_numpy(np.stack([_img(H, W, s) for s in range(7, 13)])).to(cuda)
    t = D0.prepare_image(tabs, meta=scales, depth=4, H=H, W=W)
    want = walk_reference(img, t, emit_lbf=True)
    state = walk_reference(img, t, stop=C)
    score, alive, nvis = (w.reshape(-1) for w in want[:3])
    picks = []
    for mask in (nvis == C + 1, (nvis == K) & ~alive, (nvis > C + 1) & (nvis < K), alive):
        idx = torch.nonzero(mask).reshape(-1)
        assert len(idx), "degenerate fixture"
        picks += [int(idx[0]), int(idx[-1])]
    picks = sorted(set(picks))
    for emit_lbf in (False, True):
        out = tuple(s.clone() for s in state)
        if emit_lbf:
            out += (torch.full_like(want[3], -1),)
        queue = torch.tensor(picks, dtype=torch.int32, device=cuda)
        counters = torch.tensor([len(picks), 0], dtype=torch.int32, device=cuda)
        D0.launch(img, t, out, head_carts=C, phases=D0.PHASE_SURVIVORS,
                  scratch=(queue, counters))
        torch.cuda.synchronize()
        touched = torch.zeros(score.numel(), dtype=torch.bool, device=cuda)
        touched[picks] = True
        for a, b, c in zip(out[:3], want[:3], state[:3]):
            assert torch.equal(a.reshape(-1)[touched], b.reshape(-1)[touched])
            assert torch.equal(a.reshape(-1)[~touched], c.reshape(-1)[~touched])
        if emit_lbf:
            words, ref = out[3].reshape(-1, out[3].shape[-1]), want[3].reshape(-1, want[3].shape[-1])
            assert torch.equal(words[touched & alive], ref[touched & alive])
            assert bool((words[~touched] == -1).all())


def test_detector_prepares_tables_once_per_plan_on_card(cuda, cpu_det, monkeypatch):
    """Two batches of one geometry on the card: the kernels' tables are
    prepared once, and the launches of the fused and of the non-fused path
    get that one set."""
    gdet = jt.Detector(cpu_det.params)
    calls, seen = [], []
    prepare, launch, launch_image = D0.prepare_image, D0.launch, D0.launch_image

    def counting_prepare(*a, **kw):
        calls.append((kw["H"], kw["W"]))
        return prepare(*a, **kw)

    monkeypatch.setattr(D0, "prepare_image", counting_prepare)
    monkeypatch.setattr(D0, "launch",
                        lambda *a, **kw: (seen.append(a[1]), launch(*a, **kw))[1])
    monkeypatch.setattr(D0, "launch_image",
                        lambda *a, **kw: (seen.append(a[1]), launch_image(*a, **kw))[1])
    grays = [_img(96, 128, 1), _img(96, 128, 2)]
    gdet.detect_batch(grays, th=-5.0)
    gdet.detect_batch(grays[::-1], th=-5.0)
    monkeypatch.setenv("JDA_TPU_FUSED", "0")
    gdet.detect(grays[0], th=-5.0)
    assert calls == [(96, 128)]
    assert len(seen) == 3 and isinstance(seen[0], D0.ImageTables)
    assert seen[1] is seen[0] and seen[2] is seen[0]


def test_image_kernel_phases_apart(cuda, cpu_det):
    """`dense0_image` launched one phase at a time, at several head lengths,
    equals the call of both."""
    H, W = 150, 210
    n, scales, tabs = _ladder(cpu_det, H, W, cuda)
    img = torch.from_numpy(_img(H, W, 5)).to(cuda)
    t = D0.prepare_image(tabs, meta=scales, depth=4, H=H, W=W)
    want = D0.stage0_filter_image(img, tabs, meta=scales, depth=4, prepared=t)
    for C in (1, 8, 32):
        out = tuple(torch.empty_like(w) for w in want)
        before = D0.stage0_filter_image.launches
        scr = D0.launch_image(img, t, out, head_carts=C, phases=D0.PHASE_HEAD)
        assert int(out[2].max()) == min(C, cpu_det.K)
        D0.launch_image(img, t, out, head_carts=C, phases=D0.PHASE_SURVIVORS, scratch=scr)
        torch.cuda.synchronize()
        assert D0.stage0_filter_image.launches == before + 2
        queued = int(scr[1][0])  # nothing queues once the head walks all K carts
        assert queued <= n and (queued > 0) == (C < cpu_det.K)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


def test_edited_header_changes_the_library(tmp_path, monkeypatch):
    """The library's name hashes its source and the headers beside it, so an
    edited header never loads a stale library (needs no card)."""
    (tmp_path / "k.cu").write_text('#include "walk.cuh"\n')
    (tmp_path / "walk.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    first = _build._paths("k")[1]
    assert _build._paths("k")[1] == first
    (tmp_path / "walk.cuh").write_text("// two\n")
    second = _build._paths("k")[1]
    assert second != first
    (tmp_path / "k.cu").write_text('#include "walk.cuh"\n// edited\n')
    assert _build._paths("k")[1] not in (first, second)


@pytest.mark.parametrize("rounding", [False, True], ids=["trunc", "round"])
def test_unfused_detector_on_card_matches_cpu(cuda, cpu_det, monkeypatch, rounding):
    """JDA_TPU_FUSED=0 on the card: one `dense0_image` call (two kernels)
    per image, results bit-equal to the CPU port's and to the card's fused
    path."""
    grays = [_img(96, 128, 1), _img(80, 112, 2)]
    gdet = jt.Detector(cpu_det.params, rounding=rounding)
    cdet = jt.Detector(cpu_det.params, rounding=rounding, device="cpu")
    fused = gdet.detect_batch(grays, th=-5.0)
    monkeypatch.setenv("JDA_TPU_FUSED", "0")
    before = D0.stage0_filter_image.launches
    got = gdet.detect_batch(grays, th=-5.0)
    assert D0.stage0_filter_image.launches == before + 2 * len(grays)
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


# -- the C++-semantics path (CppDetector, run_fddb) ------------------------------

CPP_CFG = dict(
    T=2, K=24, landmark_n=5, tree_depth=4, img_o_size=32, img_h_size=24,
    img_q_size=16, fddb_minimum_size=20, fddb_step=5, fddb_scale_factor=1.3,
    fddb_overlap=0.3, fddb_nms=True, left_pupils=(0,), right_pupils=(1,),
)


@pytest.fixture
def cpp_model():
    return jt.synthetic_model(T=2, K=24, landmark_n=5, seed=11,
                              drop_profile=np.full(48, 0.05))


def _same_cpp(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert a[3] == b[3]


def test_kernels_on_cpp_tables_match_plain(cuda, cpp_model):
    """Rounding tables on the method-1 ladder (windows from 20 px at a fixed
    step of 5) at B=2, and shifted tables on a banded method-0 canvas:
    `dense0_filter` bit-equal to the plain version with and without leaf
    words, `dense0_image` on the ladder of one image too."""
    from jda_tpu_torch.cascador import CppDetector

    imgs = [_img(120, 160, 21), _img(120, 160, 22)]
    det1 = CppDetector(cpp_model, jt.Config(fddb_detect_method=1, **CPP_CFG))
    det0 = CppDetector(cpp_model, jt.Config(fddb_detect_method=0, **CPP_CFG))
    p1 = det1._m1_plan(120, 160)
    p0 = det0._m0_plan(120, 160)
    assert p1["scales"][0][:2] == (20, 5) and len(p0["scales"]) > 2
    canvas = np.zeros((p0["Hc"], p0["Wc"]), np.uint8)
    for (y0, _, _), (lv, _) in zip(p0["m0_layout"], det0._pyramid_m0(imgs[0])):
        canvas[y0 : y0 + lv.shape[0], : lv.shape[1]] = lv
    for img, plan in ((np.stack(imgs), p1), (canvas[None], p0)):
        img = torch.from_numpy(img).to(cuda)
        want = [D0.scale_filter_reference(img, ti, tf, step=s, ny=ny, nx=nx, depth=4,
                                          emit_lbf=True)
                for (_, s, ny, nx), (ti, tf) in zip(plan["scales"], plan["tabs"])]
        want = [torch.cat([w[i].reshape(img.shape[0], -1, *w[i].shape[3:]) for w in want],
                          dim=1) for i in range(4)]
        for emit_lbf in (False, True):
            before = D0.scale_filter.launches
            got = D0.stage0_filter_all_scales(img, plan["tabs"], meta=plan["scales"],
                                              depth=4, emit_lbf=emit_lbf)
            torch.cuda.synchronize()
            assert D0.scale_filter.launches == before + 2
            for a, b in zip(got[:3], want[:3]):
                assert torch.equal(a, b)
            if emit_lbf:
                assert torch.equal(got[3][want[1]], want[3][want[1]])
        assert 0 < int(want[1].sum()) < want[1].numel()
    img = torch.from_numpy(imgs[0]).to(cuda)
    got = D0.stage0_filter_image(img, p1["tabs"], meta=p1["scales"], depth=4)
    want = D0.stage0_filter_image_reference(img, p1["tabs"], meta=p1["scales"], depth=4)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("method", [1, 0])
def test_cpp_detector_on_card_matches_cpu(cuda, cpp_model, method):
    """CppDetector on the card: detect (method 1: one `dense0_image` call per
    image; method 0: one `dense0_filter` call) and detect_batch (one
    `dense0_filter` call) bit-equal to the same detector on the CPU."""
    from jda_tpu_torch.cascador import CppDetector

    cfg = jt.Config(fddb_detect_method=method, **CPP_CFG)
    gdet, cdet = CppDetector(cpp_model, cfg), CppDetector(cpp_model, cfg, device="cpu")
    grays = [_img(120, 160, 23), _img(96, 128, 24)]
    before = (D0.scale_filter.launches, D0.stage0_filter_image.launches)
    got = [gdet.detect(g) for g in grays]
    torch.cuda.synchronize()
    after = (D0.scale_filter.launches, D0.stage0_filter_image.launches)
    assert (after[0] - before[0], after[1] - before[1]) == ((0, 4) if method else (4, 0))
    batch = gdet.detect_batch(grays)
    assert D0.scale_filter.launches == after[0] + 2
    want = [cdet.detect(g) for g in grays]
    assert sum(len(w[0]) for w in want) > 0, "degenerate fixture"
    for a, b, c in zip(want, got, batch):
        _same_cpp(a, b)
        _same_cpp(a, c)


def test_cpp_multi_scale_and_stp_on_card_match_cpu(cuda):
    """Method 0 of a multi-scale model (the plain dense multi-scale filter,
    no kernel) and method 1 with the similarity transform, on the card,
    bit-equal to the CPU port."""
    from jda_tpu_torch.cascador import CppDetector

    m = jt.synthetic_model(T=2, K=16, landmark_n=5, seed=13, multi_scale=True,
                           drop_profile=np.full(32, 0.05))
    img = _img(80, 100, 25)
    for kw in (dict(fddb_detect_method=0),
               dict(fddb_detect_method=1, with_similarity_transform=True)):
        cfg = jt.Config(**dict(CPP_CFG, K=16, **kw))
        gdet = CppDetector(m, cfg)
        if kw["fddb_detect_method"] == 0:
            assert gdet._m0_dense_ms_applicable()
        want = CppDetector(m, cfg, device="cpu").detect(img)
        assert len(want[0]) > 0, "degenerate fixture"
        _same_cpp(want, gdet.detect(img))


def test_run_fddb_on_card_through_imread(cuda, cpp_model, tmp_path):
    """run_fddb on the card with images fed through imread=: the fold file
    equals the CPU run's byte for byte."""
    from jda_tpu_torch.fddb import run_fddb

    os.makedirs(tmp_path / "FDDB-folds")
    names = [f"s/img_{i}" for i in range(3)]
    (tmp_path / "FDDB-folds" / "FDDB-fold-01.txt").write_text("\n".join(names) + "\n")
    by_path = {str(tmp_path / "images" / (n + ".jpg")): _img(96, 128, 30 + i)
               for i, n in enumerate(names)}
    for method in (1, 0):
        cfg = jt.Config(fddb_detect_method=method, fddb_dir=str(tmp_path), **CPP_CFG)
        out = []
        for device in (None, "cpu"):
            d = tmp_path / f"out{method}{device}"
            stats = run_fddb(cpp_model, cfg, folds=[1], out_dir=str(d),
                             imread=by_path.get, device=device)
            assert stats["images"] == 3
            out.append((d / "fold-01-out.txt").read_bytes())
        assert out[0] == out[1]


def test_training_on_card_matches_cpu(cuda):
    """A one-stage training run of a small config (8 carts, the device
    miner, the ridge solve on cuSOLVER) on the card against the port on
    the CPU: every model field but W equal, W within 1e-5 of its largest
    entry (float32 Cholesky), the corpus equal."""
    from jda_tpu_torch.data import patch_row
    from jda_tpu_torch.train.boost import Trainer

    c = jt.Config(T=1, K=8, landmark_n=5, tree_depth=4, shift_size=0.05,
                  img_o_size=32, img_h_size=24, img_q_size=16, mining_th=(0.5,),
                  feats=(60,), radius=(0.3,), probs=(0.8,), drops=(1,), nps=(1.0,),
                  score_normalization_steps=(2,), left_pupils=(0,), right_pupils=(1,),
                  snapshot_iter=10_000, seed=3)
    rng = np.random.default_rng(5)
    canon = np.array([[0.30, 0.35], [0.70, 0.35], [0.50, 0.55], [0.35, 0.75], [0.65, 0.75]])
    rows, gts = [], []
    for _ in range(150):
        img = rng.integers(110, 150, (32, 32)).astype(np.int32)
        lm = canon + rng.normal(0, 0.02, canon.shape)
        for gx, gy in lm:
            x, y = int(gx * 32), int(gy * 32)
            img[max(y - 2, 0) : y + 3, max(x - 2, 0) : x + 3] = 20
        img[2:8, 8:24] += 60
        rows.append(patch_row(np.clip(img, 0, 255).astype(np.uint8), c))
        gts.append(lm.reshape(-1))
    bgs = [_img(160, 160, 40 + i) for i in range(6)]
    out = []
    for device in (cuda, "cpu"):
        tr = Trainer(c, device=device)
        tr.mining_max_batches = 20
        tr.set_synthetic_data(np.stack(rows), np.stack(gts), bgs)
        tr.train()
        out.append(tr)
    a, b = out
    for f in ("scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores",
              "cart_th", "mean", "std"):
        np.testing.assert_array_equal(getattr(a.model, f), getattr(b.model, f), err_msg=f)
    assert np.abs(a.model.W - b.model.W).max() <= 1e-5 * np.abs(b.model.W).max()
    for x, y in ((a.pos, b.pos), (a.neg, b.neg)):
        np.testing.assert_array_equal(x.live, y.live)
        np.testing.assert_array_equal(x.weights, y.weights)
        np.testing.assert_array_equal(x.imgs, y.imgs)
    assert a.stats["mining"][0]["device_miner"] and len(a.neg.imgs) > 0
