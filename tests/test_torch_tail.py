"""The survivor tail kernel's host side on the CPU (jda_tpu_torch/ops/tail.py).

The kernel itself runs only on a card (tests/test_torch_cuda.py).  Here:
its tables against the model's fields, its compaction points against
run_fused's counts, its scheme (every lane through every stage with no
compaction, survivors counted at each compaction point, the lanes that
passed them all kept) replayed in the plain ops against run_fused, its
multi-scale walk (level reads, the int32-minimum fill, stage 0's chain from
cart 0; tests/torch_walk.py) against `Detector._run_batch`, the wrapper's
checks, and the CPU path, which never loads a library.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jda_tpu_torch as jt
from jda_tpu_torch import tracing
from jda_tpu_torch.detect import window_geometry
from jda_tpu_torch.ops import _build
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import dense0 as D0
from jda_tpu_torch.ops import fused as F
from jda_tpu_torch.ops import resize as R
from jda_tpu_torch.ops import tail as TK
import torch_walk


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.stop()
    tracing.drain()
    yield
    tracing.stop()
    tracing.drain()


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _batch():
    imgs = np.stack([_img(96, 128, 1), _img(96, 128, 2)])
    imgs[1, 80:, 112:] = 0
    return torch.from_numpy(imgs), torch.tensor([[128, 96], [112, 80]], dtype=torch.int32)


def _run_fused(det, imgs, dims):
    plan = det._plan(96, 128, 1.25, 24, 96)
    out = F.run_fused(det.dev, imgs, dims, plan["tabs"], plan["xywin"], meta=plan["scales"],
                      depth=det.depth, leaf_n=det.leaf_n, T=det.T, H=96, W=128)
    return out, plan


@pytest.mark.parametrize("depth,multi", [(4, False), (3, False), (4, True)],
                         ids=["4", "3", "4-multi-scale"])
def test_pack_tables_lays_out_the_model(depth, multi):
    m = jt.synthetic_model(T=3, K=12, landmark_n=9, tree_depth=depth, seed=5,
                           multi_scale=multi)
    dev = m.device_tensors("cpu")
    t = TK.pack_tables(dev, depth)
    node_n = (1 << (depth - 1)) - 1
    assert (t.T, t.K, t.depth, t.L2) == (3, 12, depth, 18)
    assert t.nodes_i.shape == (3, 12, node_n, 4) and t.nodes_i.dtype == torch.int32
    for i, f in enumerate(("lmk1", "lmk2", "feat_th", "scale")):
        assert torch.equal(t.nodes_i[..., i], dev[f])
    # the level column: all o for a single-scale model, each of o/h/q else
    assert set(t.nodes_i[..., 3].unique().tolist()) == ({0, 1, 2} if multi else {0})
    assert torch.equal(t.nodes_f[..., :2], dev["off1"])
    assert torch.equal(t.nodes_f[..., 2:], dev["off2"])
    assert t.cartf.shape == (3, 12, node_n + 4)
    assert torch.equal(t.cartf[..., : node_n + 1], dev["leaf_scores"])
    for i, f in enumerate(("mean", "std", "cart_th")):
        assert torch.equal(t.cartf[..., node_n + 1 + i], dev[f])
    assert torch.equal(t.W, dev["W"]) and torch.equal(t.mean_shape, dev["mean_shape"])
    assert all(x.is_contiguous() for x in (t.nodes_i, t.nodes_f, t.cartf, t.W))


def test_pack_tables_rejects_what_the_kernel_cannot_read():
    m = jt.synthetic_model(T=2, K=8, landmark_n=5, seed=5)
    dev = m.device_tensors("cpu")
    with pytest.raises(ValueError, match="depth 3"):
        TK.pack_tables(dev, 3)
    lmk = dev["lmk2"].clone()
    lmk[1, 3, 2] = 5  # one past the last of 5 landmarks
    with pytest.raises(ValueError, match="outside the shape"):
        TK.pack_tables(dict(dev, lmk2=lmk), 4)
    scale = dev["scale"].clone()
    scale[0, 1, 0] = 3  # no fourth level
    with pytest.raises(ValueError, match="level"):
        TK.pack_tables(dict(dev, scale=scale), 4)


@pytest.mark.parametrize("T,K", [(2, 20), (3, 20), (4, 20), (2, 160), (3, 160)])
def test_points_are_run_fused_compaction_points(T, K):
    m = jt.synthetic_model(T=T, K=K, landmark_n=9, seed=4, reject_rate=0.1)
    out, _ = _run_fused(jt.Detector(m, device="cpu"), *_batch())
    split = F.STAGE_SPLIT if K > 2 * F.STAGE_SPLIT else 0
    assert len(out["counts"]) == 1 + TK.n_points(T, split)


def _walk_in_plain_ops(det, imgs, dims, plan):
    """The kernel's scheme in the plain ops: the stage-0 survivors walk
    every stage with no compaction; at each compaction point the lanes
    alive are counted and each lane's `reach` grows; the lanes that passed
    every point are the final ones, and every lane banks its visits beyond
    the dense filter's into its image."""
    T, K, n, H, W = det.T, det.K, plan["n"], plan["Hc"], plan["Wc"]
    split = F.STAGE_SPLIT if K > 2 * F.STAGE_SPLIT else 0
    score_d, alive_d, nvis_d, lbf = D0.stage0_filter_all_scales(
        imgs, plan["tabs"], meta=plan["scales"], depth=det.depth, emit_lbf=True)
    xy = plan["xywin"]
    ok = ((xy[:, 0][None] <= dims[:, 0:1] - xy[:, 2][None])
          & (xy[:, 1][None] <= dims[:, 1:2] - xy[:, 2][None]))
    sel = torch.nonzero((alive_d & ok).reshape(-1)).reshape(-1)
    b, w = sel // n, sel % n
    N = len(sel)
    st = C.init_state(
        N, det.dev["mean_shape"],
        torch.stack([b * (H * W) + xy[w, 1].long() * W + xy[w, 0].long()] * 3, dim=1),
        torch.full((N, 3), W, dtype=torch.int32), torch.stack([xy[w, 2]] * 3, dim=1),
        torch.stack([xy[w, 2]] * 3, dim=1), torch.ones(N, dtype=torch.bool))
    st["score"], st["nvis"] = score_d.reshape(-1)[sel], nvis_d.reshape(-1)[sel]
    nvis0 = st["nvis"]
    leaves = F.unpack_lbf(lbf.reshape(-1, lbf.shape[-1])[sel], K)
    st = C.apply_regression(det.dev["W"][0], leaves, st, leaf_n=det.leaf_n)
    reach = torch.zeros(N, dtype=torch.int64)
    counts = [N]

    def point(alive):
        counts.append(int(alive.sum()))
        reach.add_(alive.long())

    for t in range(1, T):
        sp = C.stage_params(det.dev, t)
        parts = [(0, split), (split, K)] if split else [(0, K)]
        leaves = []
        for i, (c0, c1) in enumerate(parts):
            st, lv = C.run_cart_chunk({k: v[c0:c1] for k, v in sp.items()}, imgs.reshape(-1),
                                      st, depth=det.depth, rounding=False, single_scale=True)
            leaves.append(lv)
            if split and i == 0:
                point(st["alive"])
        st = C.apply_regression(det.dev["W"][t], torch.cat(leaves, dim=1), st,
                                leaf_n=det.leaf_n)
        if t < T - 1:
            point(st["alive"])
    keep = reach == TK.n_points(T, split)
    nvis_img = torch.where(ok, nvis_d, 0).sum(1, dtype=torch.int32).index_add(
        0, b, st["nvis"] - nvis0)
    return dict(sel=sel[keep], score=st["score"][keep], shape=st["shape"][keep],
                alive=st["alive"][keep], nvis=st["nvis"][keep],
                counts=torch.tensor(counts, dtype=torch.int32), nvis_img=nvis_img)


@pytest.mark.parametrize("K,dead", [(20, False), (160, False), (140, True)],
                         ids=["nosplit", "split", "all-die-in-stage-1"])
def test_scheme_without_compaction_equals_run_fused(K, dead):
    m = jt.synthetic_model(T=4, K=K, landmark_n=9, seed=4, reject_rate=0.05 if dead else 0.1)
    if dead:
        cart_th = m.cart_th.copy()
        cart_th[1] = 1e30
        m = dataclasses.replace(m, cart_th=cart_th)
    det = jt.Detector(m, device="cpu")
    imgs, dims = _batch()
    want, plan = _run_fused(det, imgs, dims)
    got = _walk_in_plain_ops(det, imgs, dims, plan)
    assert int(want["counts"][0]) > 0 and (want["sel"].numel() == 0) == dead
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def _ms_ladder(det, H, W, seed):
    """One image's stacked pyramid, its plan and window_geometry."""
    flat, offsets, strides = R.stack_pyramid(R.pyramid_c(_img(H, W, seed)))
    plan = det._plan(H, W, 1.25, 24, min(H, W))
    geom = window_geometry(plan["x"], plan["y"], plan["win"], offsets, strides)
    return torch.from_numpy(flat), strides, plan, geom


@pytest.mark.parametrize("T,K,reject,rounding,prefilter,hw", [
    (1, 40, 0.05, False, 64, (60, 80)),
    (2, 45, 0.05, True, 8, (72, 56)),
    (3, 70, 0.03, False, 8, (60, 80)),
    (3, 45, 0.05, True, 64, (72, 56)),
], ids=["T1-trunc", "T2-round-pre8", "T3-K70-pre8", "T3-round"])
def test_level_walk_equals_run_batch(T, K, reject, rounding, prefilter, hw, monkeypatch):
    """The multi-scale kernel's scheme (every window of the ladder through
    every stage with no compaction, stage 0's chain from cart 0, each node
    reading its level, the int32 minimum past the pyramid's end) equals
    `_run_batch` (the prefilter, then every stage on the compacted
    survivors) in every window's score, alive, nvis and shape.  The full
    ladders' quarter patches run past the stacked pyramid's end, and the
    fill decides windows there."""
    m = jt.synthetic_model(T=T, K=K, landmark_n=9, seed=4 + T, multi_scale=True,
                           reject_rate=reject)
    det = jt.Detector(m, prefilter_carts=prefilter, rounding=rounding, device="cpu")
    flat, strides, plan, geom = _ms_ladder(det, *hw, 7)
    want = det._run_batch(flat, geom, plan["n"], rounding=rounding)
    args = (TK.pack_tables(det.dev, det.depth), flat, plan["xywin"],
            torch.from_numpy(geom["base"]), tuple(strides))
    got = torch_walk.level_walk_reference(*args, rounding=rounding)
    assert 0 < want["alive"].sum() < plan["n"], "degenerate fixture"
    for k in ("score", "alive", "nvis", "shape"):
        assert np.array_equal(got[k].numpy(), want[k]), k
    q_end = geom["base"][:, 2] + (plan["win"] - 1) * (strides[2] + 1)
    assert (q_end >= flat.shape[0]).any()
    real = torch_walk.level_pixel
    monkeypatch.setattr(torch_walk, "level_pixel",
                        lambda p, i: torch.where(i < p.shape[0], real(p, i), 0))
    zero = torch_walk.level_walk_reference(*args, rounding=rounding)
    assert not torch.equal(zero["score"], got["score"])


def _walk_args(T=3, K=20, B=2, n=10, N=3):
    m = jt.synthetic_model(T=T, K=K, landmark_n=9, seed=4)
    tabs = TK.pack_tables(m.device_tensors("cpu"), 4)
    return tabs, dict(
        imgs=torch.zeros((B, 40, 40), dtype=torch.uint8),
        xywin=torch.zeros((n, 3), dtype=torch.int32),
        sel=torch.zeros(N, dtype=torch.int64),
        score0=torch.zeros((B, n)), nvis0=torch.zeros((B, n), dtype=torch.int32),
        lbf=torch.zeros((B, n, D0.lbf_words(K)), dtype=torch.int32),
        nvis_img=torch.zeros(B, dtype=torch.int32),
    )


def test_walk_raises_on_the_cpu_inside_its_span():
    """Checks pass, then no kernel for the CPU: the `tail` span (t -1, B)
    is recorded and no counter moves."""
    tabs, args = _walk_args()
    tracing.start()
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        TK.walk(tabs, **args, rounding=False, split=0)
    tracing.stop()
    spans, counters = tracing.drain()
    assert [(s.name, s.t, s.B) for s in spans] == [("tail", -1, 2)]
    assert counters == {}


def test_level_walk_raises_on_the_cpu_after_its_checks():
    """The multi-scale walk (every window, `sel`, `score0` and `nvis_img`
    None, T = 1) passes the checks and finds no kernel for the CPU."""
    tabs, args = _walk_args(T=1)
    args.update(imgs=torch.zeros((2, 2800), dtype=torch.uint8), sel=None, score0=None,
                nvis0=None, lbf=None, nvis_img=None)
    levels = (torch.zeros((10, 3), dtype=torch.int32), (40, 28, 20))
    with pytest.raises(ValueError, match="no kernel for device cpu"):
        TK.walk(tabs, **args, rounding=False, split=0, levels=levels)


@pytest.mark.parametrize("bad,match", [
    (dict(imgs=torch.zeros((2, 40, 40))), "uint8"),
    (dict(sel=torch.zeros(3, dtype=torch.int32)), "sel"),
    (dict(xywin=torch.zeros((10, 2), dtype=torch.int32)), "xywin"),
    (dict(score0=torch.zeros((2, 9))), "score0"),
    (dict(lbf=torch.zeros((2, 10, 2), dtype=torch.int32)), "lbf"),
    (dict(nvis_img=torch.zeros(2, dtype=torch.int64)), "nvis_img"),
    (dict(split=16), "split"),
    (dict(split=64), "split"),
    (dict(T=1), "T must be"),
    (dict(score0=None), "go with score0"),
    (dict(score0=None, nvis0=None), "go with score0"),
    (dict(levels=(torch.zeros((10, 3), dtype=torch.int32), (40, 28, 20))), "pyramids"),
    (dict(imgs=torch.zeros((2, 2800), dtype=torch.uint8),
          levels=(torch.zeros((10, 2), dtype=torch.int32), (40, 28, 20))), "base"),
    (dict(imgs=torch.zeros((2, 2800), dtype=torch.uint8),
          levels=(torch.zeros((10, 3), dtype=torch.int32), (40, 0, 20))), "strides"),
], ids=["imgs", "sel", "xywin", "score0", "lbf", "nvis_img", "split-round", "split-K", "T",
        "nvis0-alone", "lbf-alone", "levels-imgs", "levels-base", "levels-strides"])
def test_walk_rejects_bad_inputs(bad, match):
    bad = dict(bad)
    tabs, args = _walk_args(T=bad.pop("T", 3))
    split = bad.pop("split", 0)
    levels = bad.pop("levels", None)
    with pytest.raises(ValueError, match=match):
        TK.walk(tabs, **dict(args, **bad), rounding=False, split=split, levels=levels)


def test_cpu_detector_never_loads_a_library(monkeypatch):
    """On the CPU run_fused takes the plain tail: no library is loaded, the
    plain spans open and the kernel's counters stay at 0."""
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_build, "load", refuse)
    m = jt.synthetic_model(T=3, K=20, landmark_n=9, seed=4, reject_rate=0.2)
    det = jt.Detector(m, device="cpu")
    tracing.start()
    det.detect_batch([_img(96, 128, 1), _img(96, 128, 2)], th=-5.0)
    tracing.stop()
    spans, counters = tracing.drain()
    names = {s.name for s in spans}
    assert {"stage", "score_chain", "regression", "descend"} <= names and "tail" not in names
    assert counters["tail.lane_carts"] > 0 and det._tail is None
    assert not any(k.startswith("tail_kernel.") for k in counters)


def test_fused_sources_are_built_together(monkeypatch):
    """The first load of `dense0` or `tail` builds and loads both (one nvcc
    each, at once), the sources of a fused call; the first load of
    `pyramid` builds and loads it with `tail`, the sources of a multi-scale
    model's non-fused call, and never `dense0`; another source is built
    alone."""
    built = []
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "build_all",
                        lambda names: built.append(tuple(names)) or {k: k for k in names})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: f"lib:{path}")
    assert _build.load("tail") == "lib:tail"
    assert _build.load("dense0") == "lib:dense0"
    assert _build.load("tail") == "lib:tail"  # loaded once
    assert _build.load("dense0_image") == "lib:dense0_image"
    assert built == [("dense0", "tail"), ("dense0_image",)]
    built.clear()
    monkeypatch.setattr(_build, "_libs", {})
    assert _build.load("pyramid") == "lib:pyramid"
    assert _build.load("tail") == "lib:tail"
    assert built == [("pyramid", "tail")]
