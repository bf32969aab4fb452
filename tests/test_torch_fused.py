"""The fused pipeline's single gather pass (ops/fused.run_fused) on the CPU,
against a plain reference that is not the code under test: the port's
`cascade_full` over every window of every image, with no dense filter and
no compaction (tests/test_torch_cascade.py holds it to the JAX package).

A window that dies does so at its nvis-th cart visit, so the windows alive
after c carts of the whole cascade are those alive at the end or with
nvis > c: that gives every compaction point's survivor count, and the
lanes the pass must leave, from the reference's final state alone.  No
JAX is imported here.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jda_tpu_torch as jt
from jda_tpu_torch.cascador import CppDetector
from jda_tpu_torch.detect import Detector
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import fused as F
from jda_tpu_torch.ops import tail as TK

H, W = 64, 96
LANE_FIELDS = ("score", "shape", "alive", "nvis")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _model(T, K, survivors, seed=4):
    """A tiny single-scale model whose stage-0 survivors are none ("none"),
    all rejected by stage 1's first cart ("die1"), or some of which pass
    every stage ("some")."""
    m = jt.synthetic_model(T=T, K=K, landmark_n=9, seed=seed,
                           reject_rate=0.2 / T if K < 100 else 0.06 / T)
    th = {"none": 0, "die1": 1}.get(survivors)
    if th is None:
        return m
    cart_th = m.cart_th.copy()
    cart_th[th] = 1e30
    return dataclasses.replace(m, cart_th=cart_th)


def _run(det, imgs, dims):
    plan = det._plan(H, W, 1.25, 24, H)
    out = F.run_fused(det.dev, torch.from_numpy(imgs), torch.from_numpy(dims), plan["tabs"],
                      plan["xywin"], meta=plan["scales"], depth=det.depth,
                      leaf_n=det.leaf_n, T=det.T, H=H, W=W, rounding=plan["rounding"])
    return out, plan


def _reference(det, plan, imgs, dims):
    """cascade_full over every window of every image (flat id b * n + w):
    the final state and each window's validity in its image's dims."""
    B = imgs.shape[0]
    n = plan["n"]
    b = np.repeat(np.arange(B), n)
    x, y, win = (np.tile(plan[k].astype(np.int64), B) for k in ("x", "y", "win"))
    valid = (x <= dims[b, 0] - win) & (y <= dims[b, 1] - win)
    three = lambda a: torch.from_numpy(np.stack([a] * 3, axis=1))  # noqa: E731
    state = C.init_state(B * n, det.dev["mean_shape"], three(b * H * W + y * W + x),
                         torch.full((B * n, 3), W), three(win), three(win),
                         torch.from_numpy(valid))
    ref = C.cascade_full(det.dev, torch.from_numpy(imgs).reshape(-1), state,
                         depth=det.depth, rounding=plan["rounding"], leaf_n=det.leaf_n,
                         T=det.T, single_scale=True)
    return ref, valid


def _points(T, K):
    """The pass's compaction points, in carts of the whole cascade: after
    stage 0, after the first STAGE_SPLIT carts of each later stage (when K >
    2 * STAGE_SPLIT) and after each stage but the last."""
    split = K > 2 * F.STAGE_SPLIT
    pts = [K]
    for t in range(1, T):
        pts += [t * K + F.STAGE_SPLIT] * split + [(t + 1) * K] * (t < T - 1)
    assert len(pts) == 1 + TK.n_points(T, F.STAGE_SPLIT if split else 0)
    return pts


def _check(out, ref, valid, B, n, T, K):
    """Every output of the pass against the reference; returns the counts."""
    alive, nvis = ref["alive"].numpy(), ref["nvis"].numpy()
    pts = _points(T, K)
    counts = [int((alive | (nvis > c)).sum()) for c in pts]
    assert out["counts"].dtype == torch.int32
    assert out["counts"].tolist() == counts
    want = np.flatnonzero(alive | (nvis > pts[-1]))
    assert out["sel"].tolist() == want.tolist()
    for k in LANE_FIELDS:
        got, exp = out[k], ref[k][torch.from_numpy(want)]
        assert got.dtype == exp.dtype, k
        assert torch.equal(got, exp), k
    per_img = np.where(valid, nvis, 0).reshape(B, n).sum(1)
    assert out["nvis_img"].tolist() == per_img.tolist()
    assert int(out["total_nvis"]) == int(per_img.sum())
    return counts


CASES = [(T, K, s) for T in (1, 2, 3) for K in (40, 140)
         for s in (("none", "some") if T == 1 else ("none", "die1", "some"))]


@pytest.mark.parametrize("T,K,survivors", CASES,
                         ids=[f"T{T}-K{K}-{s}" for T, K, s in CASES])
def test_run_fused_single_pass_cases(T, K, survivors):
    """Lanes (ascending (image, window)), their score, shape, alive and
    nvis, the survivor count at each compaction point (zeros after the
    stage where every lane dies) and the per-image visits, against
    cascade_full; the second image's dims cut its windows short."""
    det = Detector(_model(T, K, survivors), device="cpu")
    imgs = np.stack([_img(H, W, 1), _img(H, W, 2)])
    imgs[1, 56:, 80:] = 0
    dims = np.array([[W, H], [80, 56]], np.int32)
    out, plan = _run(det, imgs, dims)
    ref, valid = _reference(det, plan, imgs, dims)
    counts = _check(out, ref, valid, 2, plan["n"], T, K)
    if survivors == "none":
        assert counts == [0] * len(counts)
    elif survivors == "die1":
        assert counts[0] > 0 and counts[1:] == [0] * (len(counts) - 1)
        assert not out["alive"].any()
    else:
        assert counts[-1] > 0 and out["alive"].any(), "degenerate fixture"


@pytest.mark.parametrize("rounding", [False, True], ids=["trunc", "round"])
def test_gather_pass_reads_true_pixels_at_the_last_corner(rounding):
    """Every window of a batch of 3 alive through every stage: the lanes
    whose window ends on the last image's bottom row, one of them at its
    bottom-right corner, read the batch's last pixels and equal the
    reference with the rest."""
    m = jt.synthetic_model(T=2, K=40, landmark_n=9, seed=6)
    m = dataclasses.replace(m, cart_th=np.full_like(m.cart_th, -1e30))
    det = Detector(m, device="cpu", rounding=rounding)
    imgs = np.stack([_img(H, W, 11 + i) for i in range(3)])
    dims = np.array([[W, H]] * 3, np.int32)
    out, plan = _run(det, imgs, dims)
    ref, valid = _reference(det, plan, imgs, dims)
    n = plan["n"]
    assert _check(out, ref, valid, 3, n, 2, 40)[-1] == 3 * n
    sel = out["sel"].numpy()
    wi = sel % n
    last = sel // n == 2
    right = plan["x"][wi] + plan["win"][wi] == W
    bottom = plan["y"][wi] + plan["win"][wi] == H
    assert (last & bottom).sum() > 1 and (last & right & bottom).sum() >= 1


KNOBS = {"JDA_TPU_TAIL": "mxu", "JDA_TPU_CANVAS": "gather", "JDA_TPU_BUCKETS": "default"}

CPP_CFG = dict(
    T=2, K=40, landmark_n=9, tree_depth=4, img_o_size=32, img_h_size=24,
    img_q_size=16, fddb_minimum_size=24, fddb_step=4, fddb_scale_factor=1.6,
    fddb_overlap=0.3, fddb_nms=True, left_pupils=(0,), right_pupils=(1,),
)


@pytest.mark.parametrize("knob", list(KNOBS))
def test_old_tail_knobs_change_nothing(monkeypatch, knob):
    """The variables that once chose the JAX package's canvas tail are read
    by nothing: set, detect_stream gives bit-equal results and equal
    counts, and every run_fused output of CppDetector.detect_batch's method
    0 (banded canvases) is equal in every field."""
    m = _model(2, 40, "some", seed=7)
    grays = [_img(H, W, 21), _img(56, 80, 22), _img(H, W, 23)]
    raws = []
    real = F.run_fused
    monkeypatch.setattr(F, "run_fused", lambda *a, **kw: raws.append(real(*a, **kw))
                        or raws[-1])

    def runs():
        det = Detector(m, device="cpu")
        res = det.detect_stream(grays, batch=2, th=-5.0)
        stats = det.last_stats["counts"]
        cpp = CppDetector(m, jt.Config(fddb_detect_method=0, **CPP_CFG), device="cpu")
        return res, stats, cpp.detect_batch(grays[:2])

    monkeypatch.delenv(knob, raising=False)
    want, want_counts, want_cpp = runs()
    want_raw, raws[:] = list(raws), []
    monkeypatch.setenv(knob, KNOBS[knob])
    got, got_counts, got_cpp = runs()
    assert sum(r.n for r in want) > 0, "degenerate fixture"
    assert got_counts == want_counts
    for a, b in zip(want, got):
        for k in ("bboxes", "scores", "shapes"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    for a, b in zip(want_cpp, got_cpp):
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(x, y)
        assert dataclasses.astuple(a[3]) == dataclasses.astuple(b[3])
    assert len(raws) == len(want_raw) == 3
    for a, b in zip(want_raw, raws):
        for k in a:
            assert torch.equal(a[k], b[k]), k
