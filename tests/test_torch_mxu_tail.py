"""The canvas tail (jda_tpu_torch.ops.mxu_tail and the grouped pass of
ops/fused.run_fused) against the JAX package's ops/mxu_tail.py and
make_fused_fn2, on the CPU.

Everything is bit-equal to the JAX package but one case, which the tests
below name: the JAX package's `canvas_rows` slices each canvas row with
`dynamic_slice`, which clamps a span that runs past the end of the flat
batch and so shifts the whole row.  That happens on the bottom image row
of the last image of a batch, for a lane with x + S > W.  The port's one
canvas build (its `canvas_rows`, under either JDA_TPU_CANVAS value) gives
the true pixel there, as the JAX package's `canvas_from_windows` and the
gather tail do; so where lanes reach that corner the port is held against
`canvas_from_windows` (JDA_TPU_CANVAS=gather) only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jda_tpu import params as JP
from jda_tpu.cascador import CppDetector as JCppDetector
from jda_tpu.config import Config as JConfig
from jda_tpu.detect import Detector as JDetector
from jda_tpu.detect import enumerate_windows as j_enumerate_windows
from jda_tpu.ops import cascade as JC
from jda_tpu.ops import fused as JF
from jda_tpu.ops import mxu_tail as JMT
from jda_tpu_torch import params as TP
from jda_tpu_torch.cascador import CppDetector
from jda_tpu_torch.config import Config
from jda_tpu_torch.detect import Detector, enumerate_windows
from jda_tpu_torch.ops import cascade as TC
from jda_tpu_torch.ops import fused as TF
from jda_tpu_torch.ops import mxu_tail as MT

TH = -5.0


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


def _models(**kw):
    m = JP.synthetic_model(**kw)
    return m, TP.from_arrays(dataclasses.asdict(m))


def _lanes(rng, B, H, W, N, S):
    """Random lanes (b, x, y, win <= S) inside their images."""
    b = rng.integers(0, B, N).astype(np.int32)
    win = rng.integers(S // 2, S + 1, N).astype(np.int32)
    x = (rng.random(N) * (W - win)).astype(np.int32)
    y = (rng.random(N) * (H - win)).astype(np.int32)
    return b, x, y, win


def _corner_lanes(B, H, W, S):
    """Lanes whose window ends on the last image's bottom row and whose
    canvas rows run past its right edge (x + S > W), the probe's lane
    (win 24 at (72, 40) of a 64 x 96 image) first."""
    wins = np.array([24, S // 2 + 1, S - 1, S], np.int32)
    x = np.array([72, W - S // 2 - 1, W - S + 1, W - S], np.int32)
    y = H - wins
    return np.full(4, B - 1, np.int32), x, y, wins


def _both(fn_t, fn_j, flat, b, x, y, H, W, S):
    t = fn_t(torch.from_numpy(flat), *(torch.from_numpy(a) for a in (b, x, y)), H, W, S)
    j = fn_j(jnp.asarray(flat.astype(np.int32)), *(jnp.asarray(a) for a in (b, x, y)),
             H, W, S)
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("rounding", [False, True])
def test_descend_canvas_matches_jax(rounding):
    """descend_canvas (cart_block=7: the chunked path) equals the JAX
    package's and the port's gather descent, leaves and leaf scores."""
    rng = np.random.default_rng(5)
    B, H, W, S, N = 2, 96, 128, 48, 64
    m, tm = _models(T=1, K=24, landmark_n=9, tree_depth=4, seed=2)
    jchunk = JC.stage_params(m.device_arrays(np.float32), 0)
    tdev = tm.device_tensors("cpu", torch.float32)
    tchunk = TC.stage_params(tdev, 0)
    imgs = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    flat = imgs.reshape(-1)
    b, x, y, win = _lanes(rng, B, H, W, N, S)
    shapes = (m.mean_shape[None, :].astype(np.float32)
              + rng.normal(0, 0.03, (N, m.landmark_dim)).astype(np.float32))

    tcanvas, jcanvas = _both(MT.canvas_rows, JMT.canvas_from_windows, flat, b, x, y,
                             H, W, S)
    jl, jb = JMT.descend_canvas(jchunk, jnp.asarray(jcanvas), jnp.asarray(win),
                                jnp.asarray(shapes), depth=4, rounding=rounding,
                                cart_block=7)
    tl, tb = MT.descend_canvas(tchunk, torch.from_numpy(tcanvas), torch.from_numpy(win),
                               torch.from_numpy(shapes), depth=4, rounding=rounding,
                               cart_block=7)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())

    base = (b.astype(np.int64) * H * W + y * W + x).astype(np.int32)
    state = TC.init_state(N, tdev["mean_shape"], torch.from_numpy(np.stack([base] * 3, 1)),
                          torch.full((N, 3), W), torch.from_numpy(np.stack([win] * 3, 1)),
                          torch.from_numpy(np.stack([win] * 3, 1)),
                          torch.ones(N, dtype=torch.bool))
    state["shape"] = torch.from_numpy(shapes)
    gl, gb = TC.carts_descend(tchunk, torch.from_numpy(flat), state, depth=4,
                              rounding=rounding, single_scale=True)
    assert torch.equal(gl, tl) and torch.equal(gb, tb)


def test_run_cart_chunk_canvas_matches_jax():
    rng = np.random.default_rng(8)
    B, H, W, S, N = 2, 64, 80, 32, 48
    m, tm = _models(T=2, K=24, landmark_n=9, tree_depth=4, seed=3, reject_rate=0.1)
    jchunk = JC.stage_params(m.device_arrays(np.float32), 1)
    tchunk = TC.stage_params(tm.device_tensors("cpu", torch.float32), 1)
    imgs = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    b, x, y, win = _lanes(rng, B, H, W, N, S)
    tcanvas, jcanvas = _both(MT.canvas_rows, JMT.canvas_from_windows, imgs.reshape(-1),
                             b, x, y, H, W, S)
    state = {
        "shape": (m.mean_shape[None, :]
                  + rng.normal(0, 0.03, (N, m.landmark_dim))).astype(np.float32),
        "score": rng.normal(0, 1, N).astype(np.float32),
        "alive": rng.random(N) < 0.8,
        "nvis": rng.integers(0, 30, N).astype(np.int32),
        "pw": win,
    }
    jout, jl = JMT.run_cart_chunk_canvas(
        jchunk, jnp.asarray(jcanvas), {k: jnp.asarray(v) for k, v in state.items()},
        depth=4, rounding=False)
    tout, tl = MT.run_cart_chunk_canvas(
        tchunk, torch.from_numpy(tcanvas), {k: torch.from_numpy(v) for k, v in state.items()},
        depth=4, rounding=False)
    np.testing.assert_array_equal(np.asarray(jl), tl.numpy())
    for k in ("score", "alive", "nvis", "shape", "pw"):
        np.testing.assert_array_equal(np.asarray(jout[k]), tout[k].numpy(), err_msg=k)
    assert 0 < int(tout["alive"].sum()) < int(state["alive"].sum())


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_canvas_holds_true_pixels_at_the_last_corner(dtype):
    """canvas_rows gives the true pixel at every in-bounds position (numpy
    slicing, and the JAX package's canvas_from_windows),
    on random lanes and on lanes at the last image's bottom-right corner
    whose row spans run past the batch.  There the JAX package's
    canvas_rows shifts the window's last row: the probe's lane differs
    from the image in row 23 only."""
    rng = np.random.default_rng(17)
    B, H, W, S = 2, 64, 96, 32
    imgs = rng.integers(0, 256, (B, H, W)).astype(dtype)
    flat = imgs.reshape(-1)
    lanes = [np.concatenate(p) for p in zip(_lanes(rng, B, H, W, 40, S),
                                             _corner_lanes(B, H, W, S))]
    b, x, y, win = lanes
    got, jref = _both(MT.canvas_rows, JMT.canvas_from_windows, flat, b, x, y, H, W, S)
    assert got.dtype == np.int8 and got.shape == (len(b), S, S)
    for n in range(len(b)):
        w = int(win[n])
        true = imgs[b[n], y[n] : y[n] + w, x[n] : x[n] + w].astype(np.int32) - 128
        np.testing.assert_array_equal(got[n, :w, :w], true, err_msg=f"lane {n}")
        np.testing.assert_array_equal(got[n, :w, :w], jref[n, :w, :w])
    # the JAX package's canvas_rows at the probe's lane (first corner lane)
    jrows = np.asarray(JMT.canvas_rows(jnp.asarray(flat.astype(np.int32)),
                                       *(jnp.asarray(a[40:41]) for a in lanes[:3]), H, W, S))
    bad = np.nonzero((jrows[0, :24, :24] != got[40, :24, :24]).any(1))[0]
    assert bad.tolist() == [23]


def test_canvas_matches_jax_canvas_rows_inside_the_batch():
    """On lanes whose every row span (all S rows) stays inside the flat
    batch, the JAX package's canvas_rows reads real pixels throughout, and
    the port's canvas equals it everywhere, padding included."""
    rng = np.random.default_rng(19)
    B, H, W, S = 3, 64, 96, 32
    imgs = rng.integers(0, 256, (B, H, W)).astype(np.uint8)
    b, x, y, win = _lanes(rng, B, H, W, 64, S)
    starts = (b.astype(np.int64) * H * W + y * W + x)[:, None] + np.arange(S) * W
    inside = (starts + S <= B * H * W).all(1)
    b, x, y, win = b[inside], x[inside], y[inside], win[inside]
    assert len(b) >= 48
    got, jrows = _both(MT.canvas_rows, JMT.canvas_rows, imgs.reshape(-1), b, x, y, H, W, S)
    np.testing.assert_array_equal(got, jrows)


def test_compact_canvas_and_group_scales_match_jax():
    rng = np.random.default_rng(23)
    canvas = rng.integers(-128, 128, (40, 32, 32)).astype(np.int8)
    sel = rng.integers(0, 40, 16).astype(np.int32)
    want = np.asarray(JMT.compact_canvas(jnp.asarray(canvas), jnp.asarray(sel)))
    got = MT.compact_canvas(torch.from_numpy(canvas), torch.from_numpy(sel).long())
    np.testing.assert_array_equal(want, got.numpy())
    # ladders below and across 256, and the banded buckets=() case
    for w, h, lo in ((200, 150, 24), (400, 300, 24), (1920, 1080, 24), (320, 300, 110)):
        scales = tuple(enumerate_windows(w, h, 1.25, lo, min(w, h))[3])
        assert scales == tuple(j_enumerate_windows(w, h, 1.25, lo, min(w, h))[3])
        for kw in ({}, {"buckets": ()}, {"buckets": (64, 256)}):
            assert TF.group_scales(scales, **kw) == JF.group_scales(scales, **kw), (w, h, kw)
    assert TF.GATHER_MIN == JF.GATHER_MIN


# -- the grouped pass against make_fused_fn2 ---------------------------------
# (each JAX plan compiles for 20-30 s on the CPU: the fixtures keep their
# ladders to two or three scales)

def _ladder(grays, min_size, max_size):
    Hc, Wc = max(g.shape[0] for g in grays), max(g.shape[1] for g in grays)
    return Hc, Wc, dict(min_size=min_size, max_size=max_size)


def _jax_raw(m, grays, mode, monkeypatch, min_size, max_size):
    """The JAX package's make_fused_fn2 output for a batch (its plan built
    under JDA_TPU_TAIL=mxu and JDA_TPU_CANVAS=mode), its pad lanes (sel <
    0) dropped, and its detect_batch results from the same plan."""
    monkeypatch.setenv("JDA_TPU_TAIL", "mxu")
    monkeypatch.setenv("JDA_TPU_CANVAS", mode)
    Hc, Wc, kw = _ladder(grays, min_size, max_size)
    jdet = JDetector(m)
    res = jdet.detect_batch(grays, th=TH, **kw)
    plan = jdet._fused_plan(len(grays), Hc, Wc, 1.25, min_size, max_size)
    assert plan["groups"] is not None
    imgs, dims = _canon(grays, Hc, Wc)
    raw = {k: np.asarray(v) for k, v in jdet._fused_run(plan, imgs, dims).items()}
    keep = raw["sel"] >= 0
    for k in ("sel", "score", "shape", "alive", "nvis"):
        raw[k] = raw[k][keep]
    return raw, res


def _canon(grays, Hc, Wc):
    imgs = np.zeros((len(grays), Hc, Wc), np.uint8)
    for i, g in enumerate(grays):
        imgs[i, : g.shape[0], : g.shape[1]] = g
    return imgs, np.array([[g.shape[1], g.shape[0]] for g in grays], np.int32)


def _port_raw(tdet, grays, min_size, max_size, s0_lbf=True, dims=None):
    Hc, Wc, _ = _ladder(grays, min_size, max_size)
    plan = tdet._plan(Hc, Wc, 1.25, min_size, max_size)
    imgs, own = _canon(grays, Hc, Wc)
    groups = TF.group_scales(plan["scales"])
    out = TF.run_fused(
        tdet.dev, torch.from_numpy(imgs), torch.from_numpy(own if dims is None else dims),
        plan["tabs"], plan["xywin"], meta=plan["scales"], depth=tdet.depth,
        leaf_n=tdet.leaf_n, T=tdet.T, H=Hc, W=Wc, s0_lbf=s0_lbf, groups=groups,
    )
    return {k: v.numpy() for k, v in out.items()}, groups


RAW_KEYS = ("sel", "score", "shape", "alive", "nvis", "nvis_img", "counts")


def _same_raw(want, got):
    assert len(got["sel"]) > 0, "degenerate fixture"
    for k in RAW_KEYS:
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _same_results(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.bboxes, b.bboxes)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.shapes, b.shapes)


# windows of 24, 30 and 37 px: canvas groups S=32 and S=64
SMALL = dict(min_size=24, max_size=37)


@pytest.fixture(scope="module")
def canvas_pair():
    """Two canvas groups; the last image is smaller than the canonical
    plane, so no lane reaches the batch's last corner."""
    m, tm = _models(T=3, K=20, landmark_n=9, seed=4, reject_rate=0.2)
    grays = [_img(64, 96, 1), _img(56, 80, 2)]
    return m, grays, Detector(tm, device="cpu")


def test_grouped_pass_matches_make_fused_fn2(canvas_pair, monkeypatch):
    """Lane for lane in the JAX program's order: sel, score, shape, alive,
    nvis, nvis_img and the counts of every compaction point; and
    detect_batch / detect_stream under JDA_TPU_TAIL=mxu, in both canvas
    modes, equal to the JAX package's (JDA_TPU_CANVAS=rows: no lane
    reaches the last corner, so its two modes agree) and to the port's
    gather tail."""
    m, grays, tdet = canvas_pair
    want, jres = _jax_raw(m, grays, "rows", monkeypatch, **SMALL)
    got, groups = _port_raw(tdet, grays, **SMALL)
    assert [g["S"] for g in groups] == [32, 64]
    assert len(got["counts"]) == len(groups) * (1 + m.T - 2)
    _same_raw(want, got)
    assert sum(r.n for r in jres) > 0, "degenerate fixture"
    for mode in ("rows", "gather"):
        monkeypatch.setenv("JDA_TPU_CANVAS", mode)
        _same_results(jres, tdet.detect_batch(grays, th=TH, **SMALL))
        _same_results(jres, tdet.detect_stream(grays, batch=1, th=TH, **SMALL))
    monkeypatch.setenv("JDA_TPU_TAIL", "gather")
    _same_results(jres, tdet.detect_batch(grays, th=TH, **SMALL))


def test_grouped_pass_with_a_gather_group(monkeypatch):
    """Windows of 210 and 262 px: the canvas group S=256 and the gather
    group (win >= GATHER_MIN).  The single image is the batch's last, and
    its ladder ends at its bottom-right corner, where the JAX package's
    canvas_rows shifts rows; so the port, in both canvas modes, is held
    against its canvas_from_windows (JDA_TPU_CANVAS=gather)."""
    m, tm = _models(T=3, K=16, landmark_n=9, seed=6, reject_rate=0.2)
    grays = [_img(280, 300, 5)]
    ladder = dict(min_size=210, max_size=280)
    want, jres = _jax_raw(m, grays, "gather", monkeypatch, **ladder)
    tdet = Detector(tm, device="cpu")
    got, groups = _port_raw(tdet, grays, **ladder)
    assert [g["S"] for g in groups] == [256, None]
    _same_raw(want, got)
    for mode in ("gather", "rows"):
        monkeypatch.setenv("JDA_TPU_CANVAS", mode)
        _same_results(jres, tdet.detect_batch(grays, th=TH, **ladder))
    assert min(want["counts"][0], want["counts"][-2]) > 0, "a group has no survivors"
    monkeypatch.setenv("JDA_TPU_TAIL", "gather")
    _same_results(jres, tdet.detect_batch(grays, th=TH, **ladder))


def test_grouped_pass_redescent_and_empty_groups(canvas_pair):
    """s0_lbf=False re-descends stage 0 on the canvases: the same results.
    A group without survivors keeps its entries of `counts` (zeros)."""
    m, grays, tdet = canvas_pair
    a, _ = _port_raw(tdet, grays, **SMALL)
    b, _ = _port_raw(tdet, grays, s0_lbf=False, **SMALL)
    for k in RAW_KEYS:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # images of no size: no window is valid, every group is empty
    c, _ = _port_raw(tdet, grays, dims=np.zeros((2, 2), np.int32), **SMALL)
    assert c["sel"].size == 0 and c["counts"].tolist() == [0] * len(a["counts"])
    assert c["shape"].shape == (0, m.landmark_dim) and c["nvis_img"].tolist() == [0, 0]


def test_grouped_pass_when_every_lane_dies_mid_tail():
    """Every lane rejected at stage 1 (its cart thresholds out of reach):
    each group keeps a zero at every later compaction point, and the
    per-image visit banks equal the single gather pass's."""
    m, tm = _models(T=4, K=12, landmark_n=9, seed=4, reject_rate=0.3)
    cart_th = tm.cart_th.copy()
    cart_th[1] = 1e30
    tdet = Detector(dataclasses.replace(tm, cart_th=cart_th), device="cpu")
    grays = [_img(64, 96, 1), _img(56, 80, 2)]
    got, groups = _port_raw(tdet, grays, **SMALL)
    c = got["counts"].reshape(len(groups), m.T - 1)
    assert (c[:, 0] > 0).all() and (c[:, 1:] == 0).all() and got["sel"].size == 0
    imgs, dims = _canon(grays, 64, 96)
    plan = tdet._plan(64, 96, 1.25, SMALL["min_size"], SMALL["max_size"])
    one = TF.run_fused(tdet.dev, torch.from_numpy(imgs), torch.from_numpy(dims),
                       plan["tabs"], plan["xywin"], meta=plan["scales"], depth=4,
                       leaf_n=m.leaf_n, T=m.T, H=64, W=96)
    assert int(one["counts"][0]) == int(c[:, 0].sum())
    np.testing.assert_array_equal(one["nvis_img"].numpy(), got["nvis_img"])


def test_unknown_canvas_mode_is_logged_and_runs_rows(canvas_pair, monkeypatch, capsys):
    """JDA_TPU_CANVAS outside {gather, rows} is a mode choice the JAX
    package logs and replaces by 'rows'; so does the port, where a batch
    builds canvases, and only there."""
    m, grays, tdet = canvas_pair
    monkeypatch.setenv("JDA_TPU_TAIL", "mxu")
    rows = tdet.detect_batch(grays, th=TH, **SMALL)
    monkeypatch.setenv("JDA_TPU_CANVAS", "pallas")
    capsys.readouterr()
    _same_results(rows, tdet.detect_batch(grays, th=TH, **SMALL))
    assert "JDA_TPU_CANVAS=pallas is not a supported mode" in capsys.readouterr().out
    assert tdet._canvas_mode() == "rows"
    monkeypatch.setenv("JDA_TPU_TAIL", "gather")
    capsys.readouterr()
    _same_results(rows, tdet.detect_batch(grays, th=TH, **SMALL))
    assert "JDA_TPU_CANVAS" not in capsys.readouterr().out


# -- the C++ path ---------------------------------------------------------------

CFG = dict(
    T=2, K=24, landmark_n=5, tree_depth=4, img_o_size=32, img_h_size=24,
    img_q_size=16, fddb_minimum_size=24, fddb_step=4, fddb_scale_factor=1.6,
    fddb_overlap=0.3, fddb_nms=True, left_pupils=(0,), right_pupils=(1,),
)


def _same_cpp(a, b, what):
    for name, x, y in zip(("rects", "scores", "shapes"), a[:3], b[:3]):
        assert x.shape == y.shape, (what, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")
    assert dataclasses.astuple(a[3]) == dataclasses.astuple(b[3]), what


@pytest.fixture(scope="module")
def cpp_models():
    return _models(T=2, K=24, landmark_n=5, tree_depth=4, seed=11,
                   drop_profile=np.full(48, 0.05))


def test_cpp_method1_batch_under_mxu_matches_jax(cpp_models, monkeypatch):
    """Method 1 at B=2 (windows 24, 38, 61 and 97 px: buckets 32, 64 and
    128) under JDA_TPU_TAIL=mxu, against the JAX package's CppDetector in
    the same mode and the port's gather tail.  The last image is smaller
    than the canonical plane, so no lane reaches the batch's corner."""
    m, tm = cpp_models
    grays = [_img(112, 140, 6), _img(96, 120, 7)]
    monkeypatch.setenv("JDA_TPU_TAIL", "mxu")
    want = JCppDetector(m, JConfig(fddb_detect_method=1, **CFG)).detect_batch(grays)
    tdet = CppDetector(tm, Config(fddb_detect_method=1, **CFG), device="cpu")
    got = tdet.detect_batch(grays)
    assert [g["S"] for g in tdet.det._groups(tdet._m1_plan(112, 140))] == [32, 64, 128]
    for i, (a, b) in enumerate(zip(want, got)):
        _same_cpp(a, b, f"image {i}")
    assert sum(len(r[0]) for r in got) > 0
    monkeypatch.setenv("JDA_TPU_TAIL", "gather")
    for i, (a, b) in enumerate(zip(want, tdet.detect_batch(grays))):
        _same_cpp(a, b, f"image {i}, gather tail")


def test_cpp_method0_buckets_default_matches_jax(cpp_models, monkeypatch):
    """Method 0's banded canvases under JDA_TPU_BUCKETS=default (every band
    in the S=32 bucket; at win 32 = S no canvas row runs past a window)
    against the JAX package's CppDetector in the same mode, on a batch of
    two images, and against the port's gather group (JDA_TPU_BUCKETS=none)
    image by image."""
    m, tm = cpp_models
    grays = [_img(120, 150, 4), _img(80, 100, 9)]
    tdet = CppDetector(tm, Config(fddb_detect_method=0, **CFG), device="cpu")
    none = [tdet.detect(g) for g in grays]
    monkeypatch.setenv("JDA_TPU_BUCKETS", "default")
    want = JCppDetector(m, JConfig(fddb_detect_method=0, **CFG))._detect_batch_m0(grays)
    got = tdet._detect_batch_m0(grays)
    assert [g["S"] for g in tdet.det._groups(tdet._m0_plan(120, 150))] == [32]
    for i in range(len(grays)):
        _same_cpp(want[i], got[i], f"image {i}")
        _same_cpp(none[i], got[i], f"image {i} against JDA_TPU_BUCKETS=none")
        _same_cpp(none[i], tdet.detect(grays[i]), f"image {i} alone")
    assert sum(len(r[0]) for r in got) > 0
