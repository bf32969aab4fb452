"""jda_tpu_torch.ops.dense0 against jda_tpu.ops.dense0.

The port's plain filter (`scale_filter_reference`, which the wrapper runs on
CPU tensors) must be bit-equal to the JAX package's `_scale_filter` in
score, alive, nvis and the packed leaf words, at the geometries that select
each TPU kernel on the bench ladders.  The CUDA kernel is held against the
plain filter by tests/test_torch_cuda.py (on a card) and by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.detect import Detector as JDetector
from jda_tpu.detect import enumerate_windows as j_enumerate_windows
from jda_tpu.ops import dense0 as JD
from jda_tpu_torch.ops import dense0 as TD

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
