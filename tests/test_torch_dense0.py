"""jda_tpu_torch.ops.dense0 against jda_tpu.ops.dense0.

The port's plain filter (`scale_filter_reference`, which the wrapper runs on
CPU tensors) must be bit-equal to the JAX package's `_scale_filter` in
score, alive, nvis and the packed leaf words, at the geometries that select
each TPU kernel on the bench ladders.  The CUDA kernels are held against the
plain filter by tests/test_torch_cuda.py (on a card) and by chip_smoke.py;
what their design relies on (the prepared tables, a walk split at the head's
last cart, rounds of 32 carts with the leaves ahead of the chain) is tested
here in plain PyTorch.
"""

import hypothesis
import hypothesis.strategies as st
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.detect import Detector as JDetector
from jda_tpu.detect import enumerate_windows as j_enumerate_windows
from jda_tpu.ops import dense0 as JD
from jda_tpu_torch.ops import dense0 as TD
from torch_walk import cart_leaves, walk_reference

K = 21  # not a multiple of 8: the LBF pad carts are exercised


@pytest.fixture(scope="module")
def model():
    m = JP.synthetic_model(T=1, K=K, landmark_n=9, seed=5, reject_rate=0.1)
    p32 = m.astype(np.float32)
    host0 = {
        "lmk1": m.lmk1[0],
        "lmk2": m.lmk2[0],
        "off1": p32.off1[0],
        "off2": p32.off2[0],
        "feat_th": m.feat_th[0],
        "leaf_scores": p32.leaf_scores[0],
        "mean": p32.mean[0],
        "std": p32.std[0],
        "cart_th": p32.cart_th[0],
    }
    return m, m.mean_shape.astype(np.float32), host0


def _step(win):
    return max(int(np.float32(win) * np.float32(0.1)), 1)


@pytest.mark.parametrize("rounding", [False, True])
def test_node_and_packed_tables_match(model, rounding):
    m, ms32, host0 = model
    for win in (24, 30, 57, 88, 213):
        step = _step(win)
        jt = JD.node_tables(ms32, host0, win, step, rounding=rounding)
        tt = TD.node_tables(ms32, host0, win, step, rounding=rounding)
        assert set(jt) == set(tt)
        for k in jt:
            assert jt[k].dtype == tt[k].dtype, k
            np.testing.assert_array_equal(jt[k], tt[k], err_msg=k)
        for a, b in zip(JD.pack_tables(jt, m.node_n), TD.pack_tables(tt, m.node_n)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_kernel_nodes_are_the_window_offsets(model):
    """The kernel's flat offsets decode to the truncated, clamped
    (yr, xr) = trunc((mean + offset) * win) of every (cart, node, point)."""
    m, ms32, host0 = model
    W = 131
    for win in (24, 57, 110):
        step = _step(win)
        tabi, _ = TD.pack_tables(TD.node_tables(ms32, host0, win, step), m.node_n)
        nodes = TD.kernel_nodes(
            torch.from_numpy(tabi), step=step, W=W, depth=m.tree_depth
        ).numpy()
        assert nodes.shape == (K, m.node_n, 4) and nodes.dtype == np.int32
        for p, (lmk, off) in enumerate(
            ((host0["lmk1"], host0["off1"]), (host0["lmk2"], host0["off2"]))
        ):
            xr = np.clip(((ms32[0::2][lmk] + off[..., 0]) * np.float32(win)).astype(np.int32), 0, win - 1)
            yr = np.clip(((ms32[1::2][lmk] + off[..., 1]) * np.float32(win)).astype(np.int32), 0, win - 1)
            np.testing.assert_array_equal(nodes[..., p], yr * W + xr)
        np.testing.assert_array_equal(nodes[..., 2], host0["feat_th"])
        np.testing.assert_array_equal(nodes[..., 3], 0)


def test_pad_noop_carts_match(model):
    m, ms32, host0 = model
    tabi, tabf = TD.pack_tables(TD.node_tables(ms32, host0, 24, 2), m.node_n)
    ja = JD._pad_noop_carts(jnp.asarray(tabi), jnp.asarray(tabf), m.leaf_n, 3)
    ta = TD._pad_noop_carts(torch.from_numpy(tabi), torch.from_numpy(tabf), m.leaf_n, 3)
    for a, b in zip(ja, ta):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


# (H, W, win): step 2 selects the resident kernel on VGA, step 5 the rolled
# one, and a grid wider than 128 columns is the shape of the tiled 1080p
# scales
GEOMS = {"resident_step2": (64, 96, 24), "rolled_step5": (96, 128, 57),
         "tiled_wide": (40, 300, 24)}


@pytest.mark.parametrize("emit_lbf", [False, True], ids=["nolbf", "lbf"])
@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_scale_filter_reference_bit_equal(model, geom, emit_lbf):
    m, ms32, host0 = model
    H, W, win = GEOMS[geom]
    step = _step(win)
    ny, nx = (H - win) // step + 1, (W - win) // step + 1
    img = np.random.default_rng(len(geom)).integers(0, 256, (2, H, W)).astype(np.uint8)
    tab = JD.node_tables(ms32, host0, win, step)
    jout = JD._scale_filter(
        jnp.asarray(img.astype(np.int32)),
        {k: jnp.asarray(v) for k, v in tab.items()},
        step=step, ny=ny, nx=nx, depth=4, emit_lbf=emit_lbf,
    )
    tabi, tabf = TD.pack_tables(TD.node_tables(ms32, host0, win, step), m.node_n)
    tout = TD.scale_filter(
        torch.from_numpy(img), torch.from_numpy(tabi), torch.from_numpy(tabf),
        step=step, ny=ny, nx=nx, depth=4, emit_lbf=emit_lbf,
    )
    assert len(jout) == len(tout) == (4 if emit_lbf else 3)
    alive = np.asarray(jout[1])
    assert 0 < alive.mean() < 1, "degenerate fixture"
    for name, a, b in zip(("score", "alive", "nvis", "lbf"), jout, tout):
        a = np.asarray(a)
        b = b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_stage0_all_scales_full_ladder(model):
    m, ms32, host0 = model
    H, W = 72, 104
    x, y, win, scales = j_enumerate_windows(W, H, 1.25, 24, min(H, W))
    assert len(scales) >= 5
    img = np.random.default_rng(9).integers(0, 256, (2, H, W)).astype(np.uint8)
    jtabs, ttabs = [], []
    for w_, s_, _, _ in scales:
        t = JD.node_tables(ms32, host0, w_, s_)
        jtabs.append({k: jnp.asarray(v) for k, v in t.items()})
        tabi, tabf = TD.pack_tables(t, m.node_n)
        ttabs.append((torch.from_numpy(tabi), torch.from_numpy(tabf)))
    jout = JD.stage0_filter_all_scales(
        jnp.asarray(img.astype(np.int32)), tuple(jtabs), meta=tuple(scales),
        depth=4, emit_lbf=True,
    )
    tout = TD.stage0_filter_all_scales(
        torch.from_numpy(img), ttabs, meta=scales, depth=4, emit_lbf=True
    )
    assert tout[0].shape == (2, len(x))
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("rounding", [False, True], ids=["trunc", "round"])
def test_stage0_filter_image_matches_dense_filter(model, rounding):
    """The whole-ladder filter of one image against the JAX package's
    Detector._dense_filter, which on the CPU takes its plain route
    (stage0_filter_all_scales): bit-equal, no tolerance."""
    m, ms32, host0 = model
    H, W = 75, 101
    x, _, _, scales = j_enumerate_windows(W, H, 1.25, 24, min(H, W))
    assert len(scales) >= 5
    img = np.random.default_rng(11).integers(0, 256, (H, W)).astype(np.uint8)
    jout = JDetector(m, rounding=rounding)._dense_filter(img, scales)
    tabs = []
    for w_, s_, _, _ in scales:
        tabi, tabf = TD.pack_tables(
            TD.node_tables(ms32, host0, w_, s_, rounding=rounding), m.node_n
        )
        tabs.append((torch.from_numpy(tabi), torch.from_numpy(tabf)))
    for fn in (TD.stage0_filter_image, TD.stage0_filter_image_reference):
        tout = fn(torch.from_numpy(img), tabs, meta=scales, depth=4)
        assert len(tout) == 3
        assert 0 < np.asarray(jout[1]).mean() < 1, "degenerate fixture"
        for name, a, b in zip(("score", "alive", "nvis"), jout, tout):
            assert a.dtype == b.numpy().dtype and b.shape == (len(x),), name
            np.testing.assert_array_equal(a, b.numpy(), err_msg=name)


def test_image_filter_equals_batch_filter_at_b1(model):
    """One image through stage0_filter_image equals the batch filter
    (the fused path's) at B=1, scale by scale."""
    m, ms32, host0 = model
    H, W = 64, 90
    _, _, _, scales = j_enumerate_windows(W, H, 1.25, 24, min(H, W))
    img = torch.from_numpy(
        np.random.default_rng(12).integers(0, 256, (H, W)).astype(np.uint8)
    )
    tabs = [
        tuple(map(torch.from_numpy, TD.pack_tables(TD.node_tables(ms32, host0, w_, s_), m.node_n)))
        for w_, s_, _, _ in scales
    ]
    a = TD.stage0_filter_image(img, tabs, meta=scales, depth=4)
    b = TD.stage0_filter_all_scales(img[None], tabs, meta=scales, depth=4)
    for u, v in zip(a, b):
        assert torch.equal(u, v[0])


def test_prepare_image_tables(model):
    """The kernel's tables of one geometry: per-scale records in
    enumeration order, node offsets as kernel_nodes gives them, one tabf;
    a grid that reads outside the image is refused."""
    m, ms32, host0 = model
    H, W = 64, 90
    x, _, _, scales = j_enumerate_windows(W, H, 1.25, 24, min(H, W))
    tabs = [
        tuple(map(torch.from_numpy, TD.pack_tables(TD.node_tables(ms32, host0, w_, s_), m.node_n)))
        for w_, s_, _, _ in scales
    ]
    t = TD.prepare_image(tabs, meta=scales, depth=4, H=H, W=W)
    assert t.n == len(x) and (t.H, t.W, t.depth) == (H, W, 4)
    assert t.recs.dtype == torch.int32 and t.recs.shape == (len(scales), 4)
    first = 0
    for rec, (win, step, ny, nx), (tabi, tabf), nodes in zip(
        t.recs.tolist(), scales, tabs, t.nodes
    ):
        assert rec == [first, nx, step, ny]
        first += ny * nx
        assert torch.equal(nodes, TD.kernel_nodes(tabi, step=step, W=W, depth=4))
        assert torch.equal(tabf, t.tabf)
    assert t.nodes.shape == (len(scales), K, m.node_n, 4) and t.nodes.is_contiguous()
    with pytest.raises(ValueError, match="outside the image"):
        TD.prepare_image(tabs, meta=scales, depth=4, H=H - 1, W=W)
    other = (tabs[1][0], tabs[1][1] + 1)
    with pytest.raises(ValueError, match="same for every scale"):
        TD.prepare_image([tabs[0], other], meta=scales[:2], depth=4, H=H, W=W)


def test_wrapper_refuses_other_devices(model):
    m, ms32, host0 = model
    tabi, tabf = TD.pack_tables(TD.node_tables(ms32, host0, 24, 2), m.node_n)
    img = torch.zeros((1, 30, 30), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        TD.scale_filter(img, torch.from_numpy(tabi), torch.from_numpy(tabf),
                        step=2, ny=4, nx=4, depth=4)
    with pytest.raises(ValueError, match="no kernel"):
        TD.stage0_filter_image(
            img[0], [(torch.from_numpy(tabi), torch.from_numpy(tabf))],
            meta=[(24, 2, 4, 4)], depth=4,
        )


# ---------------------------------------------------------------------------
# What the kernels' design relies on, on the CPU: the prepared tables, a walk
# split at the head's last cart, and 32-cart rounds with the leaves ahead of
# the score chain.  Everything is bit-exact (tolerance 0).
# ---------------------------------------------------------------------------

K2 = 70  # more than two rounds of 32 carts; no multiple of 32 or of 8


@pytest.fixture(scope="module")
def ladder70():
    """A K=70 model, a small ladder, B=3 images from a seed, the per-scale
    tables of both packages and the kernels' prepared tables."""
    m = JP.synthetic_model(T=1, K=K2, landmark_n=9, seed=7, reject_rate=0.1)
    p32 = m.astype(np.float32)
    host0 = {
        "lmk1": m.lmk1[0], "lmk2": m.lmk2[0], "off1": p32.off1[0], "off2": p32.off2[0],
        "feat_th": m.feat_th[0], "leaf_scores": p32.leaf_scores[0],
        "mean": p32.mean[0], "std": p32.std[0], "cart_th": p32.cart_th[0],
    }
    ms32 = m.mean_shape.astype(np.float32)
    H, W = 66, 100
    x, _, _, scales = j_enumerate_windows(W, H, 1.25, 24, min(H, W))
    assert len(scales) >= 4
    img = np.random.default_rng(21).integers(0, 256, (3, H, W)).astype(np.uint8)
    jtabs, ttabs = [], []
    for w_, s_, _, _ in scales:
        t = JD.node_tables(ms32, host0, w_, s_)
        jtabs.append({k: jnp.asarray(v) for k, v in t.items()})
        ttabs.append(tuple(map(torch.from_numpy, TD.pack_tables(t, m.node_n))))
    prepared = TD.prepare_image(ttabs, meta=scales, depth=4, H=H, W=W)
    assert prepared.n == len(x)
    return img, scales, tuple(jtabs), ttabs, prepared


@pytest.mark.parametrize("emit_lbf", [False, True], ids=["nolbf", "lbf"])
def test_prepared_tables_give_the_flat_outputs(ladder70, emit_lbf):
    """(records, stacked node tables, one tabf) -> the plain walk's flat
    outputs equal jda_tpu's stage0_filter_all_scales at B=3, leaf words on
    every window."""
    img, scales, jtabs, ttabs, prepared = ladder70
    jout = JD.stage0_filter_all_scales(
        jnp.asarray(img.astype(np.int32)), jtabs, meta=tuple(scales), depth=4,
        emit_lbf=emit_lbf,
    )
    tout = walk_reference(torch.from_numpy(img), prepared, emit_lbf=emit_lbf)
    flat = TD.stage0_filter_all_scales(
        torch.from_numpy(img), ttabs, meta=scales, depth=4, emit_lbf=emit_lbf,
        prepared=prepared,
    )
    assert len(jout) == len(tout) == len(flat) == (4 if emit_lbf else 3)
    assert 0 < np.asarray(jout[1]).mean() < 1, "degenerate fixture"
    for name, a, b, c in zip(("score", "alive", "nvis", "lbf"), jout, tout, flat):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
        np.testing.assert_array_equal(a, c.numpy(), err_msg=name)


@pytest.mark.parametrize("C", [1, 8, 32, K2])
def test_walk_split_at_cart_c_resumes_bit_equal(ladder70, C):
    """Carts [0, C), then [C, K) resumed from (score, alive, nvis, words),
    equal the unsplit walk: the head phase hands exactly this state over."""
    img, _, _, _, prepared = ladder70
    img = torch.from_numpy(img)
    whole = walk_reference(img, prepared, emit_lbf=True)
    head = walk_reference(img, prepared, stop=C, emit_lbf=True)
    assert int(head[2].max()) == C and bool((head[2] <= C).all())
    if C < K2:
        assert 0 < int(head[1].sum()) < head[1].numel(), "degenerate fixture"
    both = walk_reference(img, prepared, start=C, state=head, emit_lbf=True)
    for name, a, b in zip(("score", "alive", "nvis", "lbf"), whole, both):
        assert torch.equal(a, b), name
    # without words the state is three tensors, and they resume the same
    three = walk_reference(img, prepared, start=C, state=head[:3])
    for a, b in zip(whole, three):
        assert torch.equal(a, b)


def _warp_walk(img, t, C, emit_lbf):
    """The survivor phase as the kernel runs it, emulated for every window
    at once: from the head's state at cart C, rounds of 32 carts whose
    leaves are all computed before the score chain runs, the chain stopping
    at the first reject; words packed 8 carts to a word from the round's
    leaves, rounds from cart 0 when words are wanted.  Words of windows that
    are not walked stay -1."""
    K = t.tabf.shape[0]
    leaf_n = 1 << (t.depth - 1)
    score, alive, nvis = walk_reference(img, t, stop=C)
    C = min(C, K)
    queued = alive & ((C < K) | emit_lbf)
    score, alive, nvis = score.clone(), alive.clone(), nvis.clone()
    words = torch.full(alive.shape + (TD.lbf_words(K),), -1, dtype=torch.int32)
    live = queued.clone()  # still being walked
    for c0 in range(0 if emit_lbf else C, K, 32):
        c1 = min(c0 + 32, K)
        leaves = cart_leaves(img, t, c0, c1)  # all ahead of the chain
        if emit_lbf:
            for w0 in range(c0, c1, 8):
                word = torch.zeros(alive.shape, dtype=torch.int32)
                for k in range(w0, min(w0 + 8, c1)):
                    word |= leaves[..., k - c0] << (4 * (k % 8))
                words[..., w0 // 8] = torch.where(live, word, words[..., w0 // 8])
        for k in range(max(c0, C), c1):
            b = t.tabf[k, :leaf_n][leaves[..., k - c0].to(torch.int64)]
            s_new = (score + b - t.tabf[k, leaf_n]) / t.tabf[k, leaf_n + 1]
            score = torch.where(live, s_new, score)
            nvis = nvis + live.to(torch.int32)
            live = live & (score >= t.tabf[k, leaf_n + 2])
    alive = torch.where(queued, live, alive)
    return score, alive, nvis, words


@pytest.mark.parametrize("emit_lbf", [False, True], ids=["nolbf", "lbf"])
@pytest.mark.parametrize("C", [1, 8, 32, 64, K2, 96])
def test_rounds_of_32_carts_with_leaves_ahead(ladder70, C, emit_lbf):
    """32-cart rounds, leaves before the chain, stop at the first reject:
    score, alive and nvis of every window and the words of the windows that
    stay alive equal the cart-by-cart walk (K=70: a last round of 6 carts,
    a last word of 6 nibbles)."""
    img, _, _, _, prepared = ladder70
    img = torch.from_numpy(img)
    whole = walk_reference(img, prepared, emit_lbf=True)
    got = _warp_walk(img, prepared, C, emit_lbf)
    for name, a, b in zip(("score", "alive", "nvis"), whole, got):
        assert torch.equal(a, b), name
    if emit_lbf:
        alive = whole[1]
        assert int(alive.sum()) > 0, "degenerate fixture"
        assert torch.equal(whole[3][alive], got[3][alive])


@hypothesis.settings(max_examples=12, deadline=None, derandomize=True, database=None)
@hypothesis.given(
    seed=st.integers(0, 2**31 - 1),
    K=st.sampled_from([3, 8, 31, 33, 45]),
    C=st.sampled_from([1, 5, 8, 32, 40]),
)
def test_rounds_of_32_carts_on_random_tables(seed, K, C):
    """The same on random small tables of one scale (random offsets,
    thresholds, leaf scores and reject thresholds), built straight into the
    kernels' layout."""
    rng = np.random.default_rng(seed)
    H, W, win, step = 20, 26, 12, 2
    ny, nx = (H - win) // step + 1, (W - win) // step + 1
    nodes = np.zeros((1, K, 7, 4), np.int32)
    nodes[..., :2] = rng.integers(0, win, (1, K, 7, 2)) * W + rng.integers(0, win, (1, K, 7, 2))
    nodes[..., 2] = rng.integers(-60, 60, (1, K, 7))
    tabf = np.concatenate([
        rng.normal(0, 1, (K, 8)), rng.normal(0, 0.2, (K, 1)),
        rng.uniform(0.5, 2.0, (K, 1)), rng.normal(-1.5, 1.0, (K, 1)),
    ], axis=1).astype(np.float32)
    recs = np.array([[0, nx, step, ny]], np.int32)
    t = TD.ImageTables(
        H=H, W=W, depth=4, meta=((win, step, ny, nx),), n=ny * nx,
        recs=torch.from_numpy(recs), recs_host=recs,
        nodes=torch.from_numpy(nodes), tabf=torch.from_numpy(tabf),
    )
    img = torch.from_numpy(rng.integers(0, 256, (2, H, W)).astype(np.uint8))
    whole = walk_reference(img, t, emit_lbf=True)
    got = _warp_walk(img, t, C, True)
    for name, a, b in zip(("score", "alive", "nvis"), whole, got):
        assert torch.equal(a, b), name
    assert torch.equal(whole[3][whole[1]], got[3][whole[1]])


def test_detector_prepares_dense_tables_once_per_plan(monkeypatch):
    """Detector keeps one plan per geometry and one prepared table set per
    plan.  On the CPU two batches of one geometry share a plan, prepare
    nothing and hand the plain filter no tables; `_dense_tables` of a
    detector on a card prepares at the plan's first use and returns the
    same object after (the device is stood in for: the preparation itself
    runs wherever the plan's tables lie)."""
    import types

    import jda_tpu_torch as jt

    det = jt.Detector(
        jt.synthetic_model(T=2, K=K, landmark_n=9, seed=5, reject_rate=0.1), device="cpu"
    )
    calls, seen = [], []
    prepare, dense = TD.prepare_image, TD.stage0_filter_all_scales

    def counting_prepare(*a, **kw):
        calls.append((kw["H"], kw["W"]))
        return prepare(*a, **kw)

    def spying_dense(*a, **kw):
        seen.append(kw["prepared"])
        return dense(*a, **kw)

    monkeypatch.setattr(TD, "prepare_image", counting_prepare)
    monkeypatch.setattr(TD, "stage0_filter_all_scales", spying_dense)
    rng = np.random.default_rng(31)
    batches = [[rng.integers(0, 256, (48, 60)).astype(np.uint8) for _ in range(2)]
               for _ in range(2)]
    for grays in batches:
        det.detect_batch(grays, th=-5.0)
    assert len(det._plans) == 1 and calls == [] and seen == [None, None]
    det.detect_batch([rng.integers(0, 256, (40, 52)).astype(np.uint8)], th=-5.0)
    assert len(det._plans) == 2 and calls == []

    monkeypatch.setattr(det, "device", types.SimpleNamespace(type="cuda"))
    plans = list(det._plans.values())
    first = det._dense_tables(plans[0])
    assert isinstance(first, TD.ImageTables) and calls == [(48, 60)]
    assert det._dense_tables(plans[0]) is first and calls == [(48, 60)]
    other = det._dense_tables(plans[1])
    assert other is not first and calls == [(48, 60), (40, 52)]
    assert det._dense_tables(plans[1]) is other and len(calls) == 2
