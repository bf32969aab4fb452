"""jda_tpu_torch on a CUDA card: the kernels against their plain versions
and the detector against its own CPU path.

These tests need a card and nvcc (marker `cuda`) and import no JAX, so they
run where the port runs:

    python -m pytest tests/test_torch_cuda.py -q

Everything here is bit-exact: the kernels' float ops are IEEE
round-to-nearest in the plain versions' order.  On the card the fused
pass's gather tail is the `tail_walk` kernel, and so is the non-fused
path's walk of a multi-scale model's ladder; the fused pass's other groups
and the rest of the non-fused path run the same PyTorch ops on both
devices.
"""

import os

import numpy as np
import pytest
import torch

import jda_tpu_torch as jt
from jda_tpu_torch import tracing
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


def _launches(counters):
    """(dense0_filter, dense0_image) launches in a tracing counter dict."""
    return (counters.get("dense0_filter.launches", 0),
            counters.get("dense0_image.launches", 0))


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
    with tracing.counting() as c:
        got = D0.scale_filter(img, tabi, tabf, **kw)
    want = D0.scale_filter_reference(img, tabi, tabf, **kw)
    torch.cuda.synchronize()
    assert _launches(c) == (2, 0)  # head and survivor kernel
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
    with tracing.counting() as c:
        got = D0.stage0_filter_image(img, tabs, meta=scales, depth=4)
    torch.cuda.synchronize()
    assert _launches(c) == (0, 2)
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
    with tracing.counting() as c:
        if head_carts == D0.HEAD_CARTS:
            got = D0.stage0_filter_all_scales(
                img, tabs, meta=scales, depth=4, emit_lbf=emit_lbf, prepared=prepared
            )
        else:
            got = (torch.empty((2, n), dtype=torch.float32, device=cuda),
                   torch.empty((2, n), dtype=torch.bool, device=cuda),
                   torch.empty((2, n), dtype=torch.int32, device=cuda))
            if emit_lbf:
                got += (torch.empty((2, n, D0.lbf_words(70)), dtype=torch.int32,
                                    device=cuda),)
            D0.launch(img, prepared, got, head_carts=head_carts)
    torch.cuda.synchronize()
    assert _launches(c) == (2, 0)
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
        with tracing.counting() as c:
            scr = D0.launch_image(img, t, out, head_carts=C, phases=D0.PHASE_HEAD)
            assert int(out[2].max()) == min(C, cpu_det.K)
            D0.launch_image(img, t, out, head_carts=C, phases=D0.PHASE_SURVIVORS,
                            scratch=scr)
        torch.cuda.synchronize()
        assert _launches(c) == (0, 2)
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
    with tracing.counting() as c:
        got = gdet.detect_batch(grays, th=-5.0)
    assert _launches(c) == (0, 2 * len(grays))
    want = cdet.detect_batch(grays, th=-5.0)
    assert sum(r.n for r in want) > 0, "degenerate fixture"
    for a, b, c in zip(want, got, fused):
        for f in ("bboxes", "scores", "shapes"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            np.testing.assert_array_equal(getattr(c, f), getattr(b, f))


def test_multi_scale_detector_on_card_matches_cpu(cuda):
    """A multi-scale model (pyramid, then the tail kernel's level walk of
    the whole ladder) on the card, bit-equal to the CPU port's
    `_run_batch` (prefilter, stage loop) on the full ladder."""
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
            with tracing.counting() as c:
                got = D0.stage0_filter_all_scales(img, plan["tabs"], meta=plan["scales"],
                                                  depth=4, emit_lbf=emit_lbf)
            torch.cuda.synchronize()
            assert _launches(c) == (2, 0)
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
    with tracing.counting() as c:
        got = [gdet.detect(g) for g in grays]
    torch.cuda.synchronize()
    assert _launches(c) == ((0, 4) if method else (4, 0))
    with tracing.counting() as c:
        batch = gdet.detect_batch(grays)
    assert _launches(c) == (2, 0)
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


def _train_config(**kw):
    return jt.Config(**dict(
        T=1, K=8, landmark_n=5, tree_depth=4, shift_size=0.05, img_o_size=32,
        img_h_size=24, img_q_size=16, mining_th=(0.5,), feats=(60,), radius=(0.3,),
        probs=(0.8,), drops=(1,), nps=(1.0,), score_normalization_steps=(2,),
        left_pupils=(0,), right_pupils=(1,), snapshot_iter=10_000, seed=3, **kw))


def _train_data(c, n=150):
    """n small synthetic faces (rows, gt shapes) and 6 backgrounds."""
    from jda_tpu_torch.data import patch_row

    rng = np.random.default_rng(5)
    canon = np.array([[0.30, 0.35], [0.70, 0.35], [0.50, 0.55], [0.35, 0.75], [0.65, 0.75]])
    rows, gts = [], []
    for _ in range(n):
        img = rng.integers(110, 150, (32, 32)).astype(np.int32)
        lm = canon + rng.normal(0, 0.02, canon.shape)
        for gx, gy in lm:
            x, y = int(gx * 32), int(gy * 32)
            img[max(y - 2, 0) : y + 3, max(x - 2, 0) : x + 3] = 20
        img[2:8, 8:24] += 60
        rows.append(patch_row(np.clip(img, 0, 255).astype(np.uint8), c))
        gts.append(lm.reshape(-1))
    return np.stack(rows), np.stack(gts), [_img(160, 160, 40 + i) for i in range(6)]


def _canvas_factory(c):
    """A bright 'face' square inside clutter; odd indices off-manifold."""

    def factory(i, d=0.0):
        rng = np.random.default_rng(1000 + i)
        R = int(rng.integers(c.img_o_size, 2 * c.img_o_size))
        canvas = rng.integers(40, 200, (3 * R, 3 * R)).astype(np.uint8)
        canvas[R : 2 * R, R : 2 * R] = rng.integers(150, 255, (R, R))
        return canvas, (R, R, R), bool(i % 2)

    return factory


def test_training_on_card_matches_cpu(cuda):
    """A one-stage training run of a small config (8 carts, the device
    miner, the ridge solve on cuSOLVER) on the card against the port on
    the CPU: every model field but W equal, W within 1e-5 of its largest
    entry (float32 Cholesky), the corpus equal."""
    from jda_tpu_torch.train.boost import Trainer

    c = _train_config()
    rows, gts, bgs = _train_data(c)
    out = []
    for device in (cuda, "cpu"):
        tr = Trainer(c, device=device)
        tr.mining_max_batches = 20
        tr.set_synthetic_data(rows, gts, bgs)
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


@pytest.mark.parametrize("canvas_miner", ["1", "0"], ids=["canvas", "hard-factory"])
def test_hard_miners_through_trainer_on_card_match_cpu(cuda, monkeypatch, canvas_miner):
    """A one-stage run with both factories registered and a starved scan
    (2 scan states, one 128-window batch): CanvasHardMiner.generate (or,
    with JDA_TPU_CANVAS_MINER=0, NegGenerator.generate_hard) fills every
    shortfall on the card as on the CPU: every model field but W equal, the
    corpus, the ladder, the cursors and the Generator's next draw equal."""
    from jda_tpu_torch.train.boost import Trainer

    monkeypatch.setenv("JDA_TPU_CANVAS_MINER", canvas_miner)
    c = _train_config()
    rows, gts, bgs = _train_data(c)

    def hard_factory(i, d):
        rng = np.random.default_rng(50_000 + i)
        spread = max(8, int(120 * (1.0 - 0.4 * d)))
        return rng.integers(128 - spread, 128 + spread, (32, 32)).astype(np.uint8)

    out = []
    for device in (cuda, "cpu"):
        tr = Trainer(c, device=device)
        tr.mining_batch = 16
        tr.mining_max_batches = 1
        tr.neg_gen.n_states = 2
        tr.set_synthetic_data(rows, gts, bgs)
        tr.neg_gen.load_hard_factory(hard_factory)
        tr.neg_gen.load_canvas_factory(_canvas_factory(c))
        tr.train()
        out.append(tr)
    a, b = out
    for f in ("scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores",
              "cart_th", "mean", "std"):
        np.testing.assert_array_equal(getattr(a.model, f), getattr(b.model, f), err_msg=f)
    assert np.abs(a.model.W - b.model.W).max() <= 1e-5 * np.abs(b.model.W).max()
    for x, y in ((a.pos, b.pos), (a.neg, b.neg)):
        np.testing.assert_array_equal(x.live, y.live)
        np.testing.assert_array_equal(x.imgs, y.imgs)
    for attr in ("_hard_difficulty", "_hard_cursor", "_canvas_cursor"):
        assert getattr(a.neg_gen, attr) == getattr(b.neg_gen, attr), attr
    assert a.rng.integers(1 << 62) == b.rng.integers(1 << 62)
    key = "canvas" if canvas_miner == "1" else "hard"
    assert any(e[key] is not None and e[key]["mined"] > 0 for e in a.stats["mining"])
    assert [e["max_batches"] for e in a.stats["mining"]] == [
        e["max_batches"] for e in b.stats["mining"]]


@pytest.mark.parametrize("multi", [False, True], ids=["single-scale", "multi-scale"])
def test_truncation_synth_on_card(cuda, multi):
    """The canvas miner's synth on the card: with truncation taps the o
    plane equals the host `_subsample`; every plane equals the same synth
    on the CPU (the same float32 blend)."""
    from jda_tpu_torch.data import NegGenerator
    from jda_tpu_torch.train import mining as M

    c = _train_config(multi_scale=multi)
    o = c.img_o_size
    sizes = (o, c.img_h_size, c.img_q_size) if multi else (o,)
    D = sum(d * d for d in (o, c.img_h_size, c.img_q_size))
    g = NegGenerator(c)
    g.load_canvas_factory(_canvas_factory(c))
    m = M.CanvasHardMiner(g, c, n_slots=4, per_slot=64, device=cuda)
    m._refresh(4)
    m._ensure_dev()
    rng = np.random.default_rng(3)
    meta = [m._sample_windows(s, rng) for s in m.slots]
    valid = np.arange(m.P)[None] < np.asarray([x[3] for x in meta])[:, None]
    shift = rng.uniform(-0.05, 0.05, (m.S * m.P, 2)).astype(np.float32)
    ms = rng.uniform(0.2, 0.8, c.landmark_dim).astype(np.float32)
    flats = []
    for dev in (cuda, torch.device("cpu")):
        taps = {
            sz: tuple(torch.as_tensor(np.stack(a).astype(np.int64 if i < 2 else np.float32),
                                      device=dev)
                      for i, a in enumerate(zip(*(m._taps(x[0], sz) for x in meta))))
            for sz in sizes
        }
        flat, _, _ = M._make_synth(sizes, D)(
            m._canv_dev.to(dev),
            torch.as_tensor(np.stack([x[1] for x in meta]), device=dev),
            torch.as_tensor(np.stack([x[2] for x in meta]), device=dev),
            taps,
            torch.as_tensor(valid, device=dev),
            torch.as_tensor(shift, device=dev),
            torch.as_tensor(ms, device=dev),
        )
        flats.append(flat.cpu().numpy().reshape(m.S * m.P, D))
    v = valid.reshape(-1)
    np.testing.assert_array_equal(flats[0][v], flats[1][v])
    for sid, (w, ys, xs, n) in enumerate(meta):
        for p in range(n):
            host = M._subsample(m.slots[sid]["canvas"], int(xs[p]), int(ys[p]), w, o)
            np.testing.assert_array_equal(flats[0][sid * m.P + p, : o * o].reshape(o, o), host)


# -- the survivor tail kernel (ops/tail.py, csrc/tail.cu) -------------------------

RAW_FIELDS = ("sel", "score", "shape", "alive", "nvis", "counts", "nvis_img", "total_nvis")


@pytest.fixture
def raw(monkeypatch):
    """Every run_fused output of the block, on the host, in call order."""
    from jda_tpu_torch.ops import fused as F

    calls = []
    real = F.run_fused

    def recorded(*a, **kw):
        out = real(*a, **kw)
        calls.append({k: v.cpu() for k, v in out.items()})
        return out

    monkeypatch.setattr(F, "run_fused", recorded)
    return calls


def _tail_on_card(raw, on_cpu, on_card):
    """on_cpu() and on_card() through run_fused: every output field of every
    call bit-equal; the card launches the tail kernel once per call with
    stage-0 survivors and opens no `score_chain` span.  Returns the
    outputs."""
    on_cpu()
    want = list(raw)
    raw.clear()
    tracing.start()
    try:
        on_card()
        torch.cuda.synchronize()
    finally:
        tracing.stop()
    spans, counters = tracing.drain()
    assert len(raw) == len(want) > 0
    for w, g in zip(want, raw):
        for k in RAW_FIELDS:
            assert torch.equal(w[k], g[k]), k
    launches = sum(min(int(w["counts"][0]), 1) for w in want)
    assert counters.get("tail_kernel.launches", 0) == launches
    assert counters.get("tail_kernel.lanes", 0) == sum(int(w["counts"][0]) for w in want)
    names = {s.name for s in spans}
    assert "score_chain" not in names and "tail.lane_carts" not in counters
    assert ("tail" in names) == (launches > 0)
    return want


def test_tail_kernel_bench_model_split_truncation(cuda, raw):
    """bench.py's geometry (T=5, K=540, 27 landmarks; the split's compaction
    after 64 carts of each stage) on the C-API ladder, truncating."""
    m = jt.synthetic_model(T=5, K=540, landmark_n=27, seed=7,
                           drop_profile=jt.realistic_drop_profile(5, 540))
    cdet, gdet = jt.Detector(m, device="cpu"), jt.Detector(m)
    grays = [_img(240, 320, 41), _img(200, 300, 42)]
    want = _tail_on_card(raw, lambda: cdet.detect_batch(grays, th=-5.0),
                         lambda: gdet.detect_batch(grays, th=-5.0))
    assert len(want[0]["counts"]) == 1 + 4 + 3 and int(want[0]["counts"][-1]) > 0


@pytest.mark.parametrize("method", [1, 0], ids=["m1", "m0-banded"])
def test_tail_kernel_flagship_rounding(cuda, raw, method):
    """The trained flagship cascade through CppDetector.detect_batch on
    scenes with planted faces (rounding; method 0's banded canvases give
    each scan grid an origin), faces carried through every stage."""
    import sys

    from jda_tpu_torch.cascador import CppDetector

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from chip_smoke import make_scene

    m = jt.load_model(os.path.join(os.path.dirname(__file__), "..", "models",
                                   "flagship_synth.model"))
    cfg = jt.Config(fddb_detect_method=method)
    cdet, gdet = CppDetector(m, cfg, device="cpu"), CppDetector(m, cfg)
    grays = [make_scene(240, 320, 61 + i, faces=1)[0] for i in range(2)]
    want = _tail_on_card(raw, lambda: cdet.detect_batch(grays),
                         lambda: gdet.detect_batch(grays))
    assert int(want[0]["counts"][-1]) > 0, "degenerate fixture"


@pytest.mark.parametrize("s0_lbf", [True, False], ids=["lbf", "descend0"])
def test_tail_kernel_no_split(cuda, s0_lbf):
    """K=20 (no split's compaction), stage 0 from the leaf words or
    descended: run_fused on the card equal to the CPU in every field."""
    from jda_tpu_torch.ops import fused as F

    m = jt.synthetic_model(T=3, K=20, landmark_n=9, seed=4, reject_rate=0.2)
    imgs = np.stack([_img(64, 96, 1), _img(64, 96, 2)])
    imgs[1, 56:, 80:] = 0
    dims = np.array([[96, 64], [80, 56]], np.int32)
    outs = []
    for dev in ("cpu", "cuda"):
        det = jt.Detector(m, device=dev)
        p = det._plan(64, 96, 1.25, 24, 64)
        with tracing.counting() as c:
            out = F.run_fused(det.dev, torch.from_numpy(imgs).to(dev),
                              torch.from_numpy(dims).to(dev), p["tabs"], p["xywin"],
                              meta=p["scales"], depth=4, leaf_n=m.leaf_n, T=m.T, H=64,
                              W=96, s0_lbf=s0_lbf)
        outs.append(({k: v.cpu() for k, v in out.items()}, c))
    (want, _), (got, c) = outs
    assert len(p["scales"]) > 1 and int(want["counts"][-1]) > 0
    assert c.get("tail_kernel.launches") == 1
    for k in RAW_FIELDS:
        assert torch.equal(want[k], got[k]), k


def test_tail_kernel_when_every_lane_dies_in_stage_one(cuda, raw):
    """Every lane rejected at stage 1: zeros at every later compaction
    point, no final lane, the same per-image visits."""
    import dataclasses

    m = jt.synthetic_model(T=4, K=140, landmark_n=9, seed=4, reject_rate=0.05)
    cart_th = m.cart_th.copy()
    cart_th[1] = 1e30
    m = dataclasses.replace(m, cart_th=cart_th)
    cdet, gdet = jt.Detector(m, device="cpu"), jt.Detector(m)
    grays = [_img(96, 128, 3), _img(80, 112, 4)]
    want = _tail_on_card(raw, lambda: cdet.detect_batch(grays, th=-5.0),
                         lambda: gdet.detect_batch(grays, th=-5.0))
    counts = want[0]["counts"].tolist()
    assert counts[0] > 0 and counts[1:] == [0] * 5 and want[0]["sel"].numel() == 0


# -- the tail kernel's multi-scale walk (Detector._walk_levels) ------------------


def _ms_ladder(det, H, W, seed):
    """One image's stacked pyramid on the detector's device, its levels'
    offsets and strides, its plan and window_geometry."""
    from jda_tpu_torch.detect import window_geometry
    from jda_tpu_torch.ops import resize as R

    flat, offsets, strides = R.stack_pyramid(R.pyramid_c(_img(H, W, seed)))
    plan = det._plan(H, W, 1.25, 24, min(H, W))
    geom = window_geometry(plan["x"], plan["y"], plan["win"], offsets, strides)
    return torch.from_numpy(flat).to(det.device), offsets, strides, plan, geom


@pytest.mark.parametrize("T,K,reject,rounding,prefilter,hw", [
    (1, 40, 0.05, False, 64, (60, 80)),
    (2, 45, 0.05, True, 8, (72, 56)),
    (3, 70, 0.03, False, 8, (60, 80)),
    (3, 45, 0.05, True, 64, (72, 56)),
    (5, 540, None, False, 64, (240, 320)),
], ids=["T1-trunc", "T2-round-pre8", "T3-K70-pre8", "T3-round", "T5-K540"])
def test_level_walk_matches_run_batch(cuda, T, K, reject, rounding, prefilter, hw):
    """The kernel's multi-scale walk of a whole ladder (one launch) against
    the plain `_run_batch` on the card, bit for bit: every window's score,
    alive, nvis and shape.  K is not a multiple of 32; the full ladders'
    half and quarter patches read past the stacked pyramid's end; the last
    case is the benchmark's geometry and drop profile."""
    kw = (dict(drop_profile=jt.realistic_drop_profile(T, K)) if reject is None
          else dict(reject_rate=reject))
    m = jt.synthetic_model(T=T, K=K, landmark_n=9 if K < 540 else 27, seed=4 + T,
                           multi_scale=True, **kw)
    gdet = jt.Detector(m, prefilter_carts=prefilter, rounding=rounding)
    flat, offsets, strides, plan, geom = _ms_ladder(gdet, *hw, 7)
    q_end = geom["base"][:, 2] + (plan["win"] - 1) * (strides[2] + 1)
    assert (q_end >= flat.shape[0]).any()
    want = gdet._run_batch(flat, geom, plan["n"], rounding=rounding)
    with tracing.counting() as c:
        got = gdet._walk_levels(flat, plan, offsets, strides)
        torch.cuda.synchronize()
    assert (c.get("tail_kernel.launches"), c.get("tail_kernel.ms_lanes")) == (1, plan["n"])
    assert 0 < want["alive"].sum() < plan["n"], "degenerate fixture"
    for k in ("score", "alive", "nvis", "shape"):
        assert np.array_equal(got[k].cpu().numpy(), want[k]), k


def test_multi_scale_detect_walks_one_launch_an_image(cuda, monkeypatch):
    """detect_stream, detect_batch and detect of a multi-scale model on the
    card: one tail kernel launch an image, every ladder window queued to
    the level walk, none of the plain tail's spans or `_run_batch`, and the
    CPU port's answers bit for bit.  CppDetector.detect still takes
    `_run_batch` on the card."""
    from jda_tpu_torch.cascador import CppDetector

    m = jt.synthetic_model(T=3, K=45, landmark_n=9, seed=14, multi_scale=True,
                           reject_rate=0.05)
    gdet, cdet = jt.Detector(m), jt.Detector(m, device="cpu")
    grays = [_img(60, 80, 21), _img(72, 56, 22), _img(60, 80, 23)]
    windows = sum(gdet._plan(g.shape[0], g.shape[1], 1.25, 24, min(g.shape))["n"]
                  for g in grays)
    calls = []
    run_batch = jt.Detector._run_batch
    monkeypatch.setattr(jt.Detector, "_run_batch",
                        lambda self, *a, **kw: calls.append(1) or run_batch(self, *a, **kw))
    want = cdet.detect_batch(grays, th=-5.0)
    assert sum(r.n for r in want) > 0 and len(calls) == len(grays)
    calls.clear()
    for run in (lambda: gdet.detect_stream(grays, batch=2, th=-5.0),
                lambda: gdet.detect_batch(grays, th=-5.0),
                lambda: [gdet.detect(g, th=-5.0) for g in grays]):
        tracing.start()
        try:
            got = run()
            torch.cuda.synchronize()
        finally:
            tracing.stop()
        spans, counters = tracing.drain()
        names = {s.name for s in spans}
        assert counters.get("tail_kernel.launches") == len(grays)
        assert counters.get("tail_kernel.ms_lanes") == counters.get("tail_kernel.lanes") == windows
        assert not {"score_chain", "descend", "regression", "run_batch"} & names
        assert "run_batch.calls" not in counters and not calls
        for a, b in zip(want, got):
            for f in ("bboxes", "scores", "shapes"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    cpp = CppDetector(m, jt.Config(T=3, K=45, landmark_n=9, fddb_detect_method=1,
                                   fddb_minimum_size=24, fddb_step=8))
    with tracing.counting() as c:
        cpp.detect(grays[0])
    assert len(calls) == 1 and not any(k.startswith("tail_kernel.") for k in c)


def test_tail_wrapper_rejects_bad_inputs(cuda, cpu_det):
    from jda_tpu_torch.ops import tail as TK

    tabs = TK.pack_tables(jt.Detector(cpu_det.params).dev, 4)
    B, n = 2, 10
    imgs = torch.zeros((B, 40, 40), dtype=torch.uint8, device=cuda)
    xywin = torch.zeros((n, 3), dtype=torch.int32, device=cuda)
    args = dict(
        xywin=xywin, sel=torch.zeros(3, dtype=torch.int64, device=cuda),
        score0=torch.zeros((B, n), device=cuda),
        nvis0=torch.zeros((B, n), dtype=torch.int32, device=cuda), lbf=None,
        nvis_img=torch.zeros(B, dtype=torch.int32, device=cuda),
    )
    kw = dict(rounding=False, split=0)
    with pytest.raises(ValueError, match="uint8"):
        TK.walk(tabs, imgs.float(), **args, **kw)
    with pytest.raises(ValueError, match="sel"):
        TK.walk(tabs, imgs, **dict(args, sel=args["sel"].int()), **kw)
    with pytest.raises(ValueError, match="device"):
        TK.walk(tabs, imgs, **dict(args, xywin=xywin.cpu()), **kw)
    with pytest.raises(ValueError, match="lbf"):
        TK.walk(tabs, imgs, **dict(args, lbf=torch.zeros((B, n, 1), dtype=torch.int32,
                                                          device=cuda)), **kw)
    with pytest.raises(ValueError, match="split"):
        TK.walk(tabs, imgs, **args, rounding=False, split=16)


def test_tail_wrapper_raises_when_build_missing(cuda, cpu_det, monkeypatch):
    from jda_tpu_torch.ops import tail as TK

    tabs = TK.pack_tables(jt.Detector(cpu_det.params).dev, 4)
    monkeypatch.setattr(_build, "CSRC", "/nonexistent-csrc")
    monkeypatch.setattr(_build, "_libs", {})
    imgs = torch.zeros((1, 40, 40), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="kernel source missing"):
        TK.walk(tabs, imgs, torch.zeros((4, 3), dtype=torch.int32, device=cuda),
                torch.zeros(1, dtype=torch.int64, device=cuda),
                torch.zeros((1, 4), device=cuda),
                torch.zeros((1, 4), dtype=torch.int32, device=cuda), None,
                torch.zeros(1, dtype=torch.int32, device=cuda), rounding=False, split=0)


# -- the o/h/q pyramid kernel (ops/pyramid.py, csrc/pyramid.cu) -------------------

# odd widths and heights (25x37: the last word of the buffer is partial; 72x56:
# q starts mid-word), VGA (the q ratio 479/240) and 1080p (h 1357 wide, q
# mid-word, the buffer's end mid-word)
PYRAMID_SWEEP = [(24, 24), (25, 37), (37, 25), (31, 53), (60, 80), (72, 56),
                 (480, 640), (1080, 1920)]


@pytest.mark.parametrize("hw", PYRAMID_SWEEP, ids=["x".join(map(str, s)) for s in PYRAMID_SWEEP])
def test_pyramid_kernel_is_pyramid_c(cuda, hw):
    """One launch writes h and q bit-equal to the host pyramid and to the
    plain twin on the card, and leaves o and nothing past F touched."""
    from jda_tpu_torch.ops import pyramid as PY
    from jda_tpu_torch.ops import resize as R

    img = _img(*hw, hw[0] + hw[1])
    want, offsets, strides = R.stack_pyramid(R.pyramid_c(img))
    lay = PY.layout(*hw)
    assert lay.F == want.shape[0]
    guard = torch.full((lay.F + 8,), 77, dtype=torch.uint8, device=cuda)
    flat = guard[: lay.F]
    flat[: hw[0] * hw[1]] = torch.from_numpy(img).reshape(-1).to(cuda)
    with tracing.counting() as c:
        PY.fill_levels(flat, lay)
    plain = flat.clone()
    plain[hw[0] * hw[1]:] = 0
    PY.fill_levels_reference(plain, lay)
    torch.cuda.synchronize()
    assert c.get("pyramid_kernel.launches") == 1
    assert np.array_equal(flat.cpu().numpy(), want)
    assert torch.equal(plain, flat)
    assert (guard[lay.F:] == 77).all()
    # the detector's step: the image staged in pinned memory, then the launch
    det = jt.Detector(jt.synthetic_model(T=1, K=8, landmark_n=9, seed=3, multi_scale=True))
    with tracing.counting() as c:
        got, got_offsets, got_strides = det._pyramid(img, {})
    assert c.get("pyramid_kernel.launches") == 1
    assert got.device.type == "cuda" and np.array_equal(got.cpu().numpy(), want)
    assert np.array_equal(got_offsets, offsets) and np.array_equal(got_strides, strides)


def test_pyramid_wrapper_rejects_bad_inputs(cuda):
    from jda_tpu_torch.ops import pyramid as PY

    lay = PY.layout(24, 30)
    wide = torch.zeros(2 * lay.F, dtype=torch.uint8, device=cuda)
    for bad in (wide[: lay.F].float(), wide[: lay.F][None], wide[::2]):
        with pytest.raises(ValueError, match="contiguous uint8"):
            PY.fill_levels(bad, lay)
    with pytest.raises(ValueError, match="4-byte"):
        PY.fill_levels(wide[1 : lay.F + 1], lay)
    with pytest.raises(ValueError, match="bytes"):
        PY.fill_levels(wide[: lay.F + 1], lay)


def test_pyramid_kernel_launches_once_an_image(cuda):
    """detect_stream of a multi-scale model on the card: one pyramid launch
    and one `pyramid` span an image, the image uploaded alone."""
    m = jt.synthetic_model(T=2, K=40, landmark_n=9, seed=5, multi_scale=True,
                           reject_rate=0.05)
    det = jt.Detector(m)
    grays = [_img(60, 80, 31), _img(72, 56, 32), _img(60, 80, 33)]
    det.detect_stream(grays, batch=2, th=-5.0)  # warm: the libraries
    tracing.start()
    try:
        det.detect_stream(grays, batch=2, th=-5.0)
        torch.cuda.synchronize()
    finally:
        tracing.stop()
    spans, counters = tracing.drain()
    assert counters.get("pyramid_kernel.launches") == len(grays)
    assert [s.name for s in spans].count("pyramid") == len(grays)
    assert counters.get("tail_kernel.launches") == len(grays)


def test_ms_synth_geometry_on_card_matches_cpu_and_reference(cuda):
    """The benchmark's multi-scale configuration (T=5, K=540, 27 landmarks,
    its stored thresholds) through detect_stream on the card: the card
    pyramid and the level walk give the CPU detector's answers and the
    plain reference's (benchmark/reference_ms.py, on the card), on ladders
    whose quarter patches read past the stacked buffer's end."""
    import json

    from benchmark import frozen as BF
    from benchmark import model_ms as MM
    from benchmark import reference as BR
    from benchmark import reference_ms as RM
    from jda_tpu_torch import params as P
    from jda_tpu_torch.ops import pyramid as PY

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark/configs/jda_t5k540_ms_synth.json")) as f:
        config = json.load(f)
    m = MM.fields(config, root)
    params = P.from_arrays(dict(m, stage_idx=config["T"] + 1, cart_idx=-1))
    gdet, cdet = jt.Detector(params), jt.Detector(params, device="cpu")
    kw = config["detect"]
    found = 0
    for hw in ((72, 56), (120, 160), (240, 320)):
        pool = np.stack([BF.make_image(*hw, 10 * i + hw[0]) for i in range(4)])
        x, y, win, _ = BR.ladder_windows(BR.c_api_ladder(*hw, 1.25, 24, -1))
        lay = PY.layout(*hw)
        last = (RM.patch_bases(x, y, lay.offsets, lay.strides)[:, 2]
                + (win - 1) * lay.strides[2] + win - 1)
        assert (last >= lay.F).any()
        got = gdet.detect_stream(list(pool), batch=4, **kw)
        want = cdet.detect_stream(list(pool), batch=4, **kw)
        ref, _, _ = RM.answers(config, {}, m, pool, cuda)
        for a, b, r in zip(got, want, ref):
            for f, i in (("bboxes", 0), ("scores", 1), ("shapes", 2)):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
                np.testing.assert_array_equal(getattr(a, f), r[i])
            found += a.n
    assert found > 0, "degenerate fixture"
