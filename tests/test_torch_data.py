"""The port's data layer against jda_tpu on the CPU: similarity transforms,
corpus rows, corpus snapshots (byte-identical and loadable across the
packages), the device mirrors, file loading and the host mining stream."""

import numpy as np
import pytest

import jda_tpu.data as JD
import jda_tpu_torch.data as PD

from test_training import _tiny_config, build_synthetic, make_face
from torch_train_util import port_config, one_torch_thread  # noqa: F401 (fixture)


def _corpus_pair(c, seed=3, n_pos=40, n_neg=30):
    """The same corpus state in both packages: positives with gt shapes and
    a shape mask, negatives appended as mined, some rows dead."""
    rng = np.random.default_rng(seed)
    rows, gts, _ = build_synthetic(c, n_pos=n_pos, n_bg=1, seed=seed)
    out = []
    for mod, cc in ((JD, c), (PD, port_config(c))):
        pos, neg = mod.DataSet(cc, True), mod.DataSet(cc, False)
        pos.imgs = rows.copy()
        pos.gt_shapes = gts.astype(np.float64)
        pos.shape_mask = np.where(np.arange(n_pos) % 7 == 3, -1, 1).astype(np.int32)
        pos.calc_mean_shape()
        pos.current_shapes = pos.random_shapes(np.random.default_rng(seed))
        pos.scores = np.random.default_rng(seed + 1).normal(0, 1, n_pos)
        pos.last_scores = np.zeros(n_pos)
        pos.weights = np.random.default_rng(seed + 2).uniform(0, 1e-2, n_pos)
        pos.stp_mc = mod.st_identity(n_pos)
        pos.stp_cm = mod.st_identity(n_pos)
        pos.live = np.random.default_rng(seed + 3).uniform(size=n_pos) > 0.2
        neg_rows = np.random.default_rng(seed + 4).integers(0, 256, (n_neg, rows.shape[1])).astype(np.uint8)
        neg_shapes = pos.mean_shape[None] + np.random.default_rng(seed + 5).normal(0, 0.01, (n_neg, gts.shape[1]))
        neg.append_negatives(neg_rows, np.linspace(-1, 1, n_neg), neg_shapes, pos.mean_shape)
        neg.live[::4] = False
        out.append((pos, neg))
    return out


def test_st_helpers_match_jax():
    rng = np.random.default_rng(0)
    s1 = rng.uniform(0, 1, (9, 10))
    s2 = rng.uniform(0, 1, (9, 10))
    for en in (False, True):
        np.testing.assert_array_equal(PD.st_calc(s1, s2, en), JD.st_calc(s1, s2, en))
    m = JD.st_calc(s1, s2, True)
    np.testing.assert_array_equal(PD.st_apply(m, s1), JD.st_apply(m, s1))
    np.testing.assert_array_equal(PD.st_identity(4), JD.st_identity(4))


@pytest.mark.parametrize("box", [(5, 7, 30, 30), (-6, 3, 40, 25), (20, 30, 64, 64)])
def test_get_face_and_patch_row_match_jax(box):
    """Crops with black fill, and rows resized by cv2_resize bit-equal to
    the JAX package's cv2.resize (downscales, upscales, a flipped face)."""
    c = _tiny_config()
    img = np.random.default_rng(1).integers(0, 256, (70, 90)).astype(np.uint8)
    face = PD.get_face(img, *box)
    np.testing.assert_array_equal(face, JD.get_face(img, *box))
    np.testing.assert_array_equal(PD.patch_row(face, c), JD.patch_row(face, c))
    np.testing.assert_array_equal(
        PD.patch_row(face[:, ::-1], c), JD.patch_row(face[:, ::-1], c)
    )


def test_snapshot_byte_identical_and_cross_loadable(tmp_path):
    c = _tiny_config()
    (jp, jn), (pp, pn) = _corpus_pair(c)
    jpath, ppath = str(tmp_path / "jax.data"), str(tmp_path / "port.data")
    JD.DataSet.snapshot(jp, jn, jpath)
    PD.DataSet.snapshot(pp, pn, ppath)
    with open(jpath, "rb") as f1, open(ppath, "rb") as f2:
        assert f1.read() == f2.read()
    # the JAX snapshot loads in the port, and the port's in the JAX package
    pc = port_config(c)
    pos2, neg2 = PD.DataSet(pc, True), PD.DataSet(pc, False)
    PD.DataSet.resume(jpath, pos2, neg2)
    jpos2, jneg2 = JD.DataSet(c, True), JD.DataSet(c, False)
    JD.DataSet.resume(ppath, jpos2, jneg2)
    for a, b in ((pos2, jpos2), (neg2, jneg2)):
        for f in ("imgs", "gt_shapes", "shape_mask", "current_shapes", "scores",
                  "weights", "live", "stp_mc", "last_scores"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(pos2.mean_shape, jp.mean_shape)
    # and written again, the same bytes
    again = str(tmp_path / "again.data")
    PD.DataSet.snapshot(pos2, neg2, again)
    with open(jpath, "rb") as f1, open(again, "rb") as f2:
        assert f1.read() == f2.read()


def test_boosting_state_ops_match_jax():
    c = _tiny_config()
    (jp, jn), (pp, pn) = _corpus_pair(c, seed=9)
    JD.DataSet.update_weights(jp, jn)
    PD.DataSet.update_weights(pp, pn)
    np.testing.assert_array_equal(pp.weights, jp.weights)
    np.testing.assert_array_equal(pn.weights, jn.weights)
    assert PD.DataSet.calc_mean_std(pp, pn) == JD.DataSet.calc_mean_std(jp, jn)
    for ds_p, ds_j in ((pp, jp), (pn, jn)):
        assert ds_p.calc_threshold_by_number(2) == ds_j.calc_threshold_by_number(2)
        assert ds_p.calc_threshold_by_rate(0.3) == ds_j.calc_threshold_by_rate(0.3)
        th = ds_j.calc_threshold_by_rate(0.6)
        assert ds_p.pre_remove(th) == ds_j.pre_remove(th)
        ds_p.remove(th)
        ds_j.remove(th)
        np.testing.assert_array_equal(ds_p.live, ds_j.live)
        np.testing.assert_array_equal(ds_p.imgs, ds_j.imgs)
    np.testing.assert_array_equal(
        pp.shape_residual(np.arange(len(pp.imgs)), 2),
        jp.shape_residual(np.arange(len(jp.imgs)), 2),
    )


def test_device_mirrors_follow_appends_and_compaction():
    """The mirrors are built once, then appended to and compacted on the
    device; they always equal the host arrays (the shapes in float32)."""
    c = _tiny_config(with_similarity_transform=True)
    _, (pp, pn) = _corpus_pair(c, seed=4)
    pn.device = "cpu"
    pn.calc_st_parameters(pp.mean_shape)

    def check(ds):
        S = c.img_o_size
        np.testing.assert_array_equal(ds.rows_dev().numpy(), ds.imgs)
        np.testing.assert_array_equal(ds.flat_dev().numpy(), ds.imgs.reshape(-1))
        np.testing.assert_array_equal(
            ds.canvas_dev().numpy(), ds.imgs[:, : S * S].reshape(-1, S, S)
        )
        np.testing.assert_array_equal(
            ds.shapes_dev().numpy(), ds.current_shapes.astype(np.float32)
        )
        np.testing.assert_array_equal(ds.stp_dev().numpy(), ds.stp_mc.astype(np.float32))

    check(pn)
    first = pn.rows_dev()
    rng = np.random.default_rng(2)
    more = rng.integers(0, 256, (5, pn.D)).astype(np.uint8)
    pn.append_negatives(more, np.zeros(5), pn.current_shapes[:5] + 0.01, pp.mean_shape)
    assert pn.rows_dev() is not first  # appended on the device, not rebuilt
    check(pn)
    pn.live[: len(pn.imgs) * 3 // 4] = False
    pn.remove(-1e30)  # compacts: fewer than half alive
    assert len(pn.imgs) == pn.size
    check(pn)


def test_transform_matches_cv2_flips():
    """The eight background transforms of the JAX package (cv2.flip and
    cv2.transpose) as numpy flips and transposes."""
    img = np.random.default_rng(3).integers(0, 256, (11, 17)).astype(np.uint8)
    g = JD.NegGenerator(_tiny_config())
    for t in range(8):
        want = g._transform(img, t)
        got = PD.NegGenerator._transform(img, t)
        assert got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, want)


def _validate_numpy(c):
    """A plain validator: accepts rows whose mean o-patch pixel is above 120,
    scores and shapes from the pixels (no cascade, no randomness)."""
    S = c.img_o_size

    def validate(rows):
        m = rows[:, : S * S].astype(np.float64).mean(1)
        n = len(rows)
        return (
            m > 120,
            m / 255.0,
            np.tile(m[:, None] / 255.0, (1, c.landmark_dim)),
            (rows[:, 0] % 7).astype(np.int64),
        )

    return validate


def test_host_mining_stream_matches_jax():
    """NegGenerator.generate (the host path, as JDA_TPU_DEVICE_MINER=0
    takes it): the same rows, scores, shapes and statistics, and the scan
    states advanced alike."""
    c = _tiny_config()
    _, _, bgs = build_synthetic(c, n_pos=1, n_bg=5)
    out = []
    for mod, cc in ((JD, c), (PD, port_config(c))):
        g = mod.NegGenerator(cc)
        g.load_images(bgs, np.random.default_rng(8))
        out.append((g, g.generate(_validate_numpy(c), 700, batch=128, max_batches=12)))
    (gj, (rj, sj, shj, stj)), (gp, (rp, sp, shp, stp)) = out
    assert len(rp) > 100
    np.testing.assert_array_equal(rp, rj)
    np.testing.assert_array_equal(sp, sj)
    np.testing.assert_array_equal(shp, shj)
    assert stp == stj
    for a, b in zip(gj.states, gp.states):
        assert (a.x, a.y, a.win_size, a.current_idx, a.transform_type) == (
            b.x, b.y, b.win_size, b.current_idx, b.transform_type)


def test_load_positive_and_hard_pool_match_jax(tmp_path):
    """File loading (OpenCV reads the images, cv2_resize resizes them):
    positives with flip augmentation, the hard list and its binary cache."""
    import cv2

    c = _tiny_config(face_augment_on=True, use_hard=True,
                     symmetric_landmarks=((0, 3), (1, 4)))
    rng = np.random.default_rng(12)
    lines = []
    for i in range(6):
        face, lm = make_face(rng, 50)
        frame = rng.integers(0, 256, (80, 80)).astype(np.uint8)
        frame[10:60, 12:62] = face
        p = str(tmp_path / f"f{i}.png")
        cv2.imwrite(p, frame)
        lm_abs = lm.copy()
        lm_abs[0::2] = lm_abs[0::2] * 50 + 12
        lm_abs[1::2] = lm_abs[1::2] * 50 + 10
        lines.append(p + " 12 10 50 50 " + " ".join(f"{v:.3f}" for v in lm_abs))
    (tmp_path / "face.txt").write_text("\n".join(lines) + "\n")
    names = []
    for i in range(4):
        p = str(tmp_path / f"hard_{i}.png")
        cv2.imwrite(p, rng.integers(0, 256, (40 + 9 * i, 37)).astype(np.uint8))
        names.append(p)
    (tmp_path / "hard.txt").write_text("\n".join(names) + "\n")
    bg = str(tmp_path / "bg.png")
    cv2.imwrite(bg, rng.integers(0, 256, (120, 120)).astype(np.uint8))
    (tmp_path / "bg.txt").write_text(bg + "\n")

    jpos = JD.DataSet(c, True)
    jpos.load_positive(str(tmp_path / "face.txt"), np.random.default_rng(1))
    ppos = PD.DataSet(port_config(c), True)
    ppos.load_positive(str(tmp_path / "face.txt"), np.random.default_rng(1))
    for f in ("imgs", "gt_shapes", "shape_mask", "current_shapes", "mean_shape"):
        np.testing.assert_array_equal(getattr(ppos, f), getattr(jpos, f), err_msg=f)
    assert len(ppos.imgs) == 12

    txts = [str(tmp_path / "hard.txt"), str(tmp_path / "bg.txt")]
    gj = JD.NegGenerator(c, n_states=2)
    gj.load(txts, np.random.default_rng(1))
    cache_j = (tmp_path / "hard.data").read_bytes()
    gp = PD.NegGenerator(port_config(c), n_states=2)
    gp.load(txts, np.random.default_rng(1))
    assert (tmp_path / "hard.data").read_bytes() == cache_j
    assert len(gp.hards) == 4
    for a, b in zip(gj.hards, gp.hards):
        np.testing.assert_array_equal(a, b)
    gp2 = PD.NegGenerator(port_config(c), n_states=2)
    gp2.load([str(tmp_path / "hard.data"), txts[1]], np.random.default_rng(1))
    for a, b in zip(gj.hards, gp2.hards):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gp.next_patch(0), gj.next_patch(0))  # hard first


def test_readable_errors_without_opencv(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *a, **kw):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv2)
    with pytest.raises(ImportError, match="OpenCV"):
        PD.NegGenerator._imread("x.png")
    ds = PD.DataSet(port_config(_tiny_config()), True)
    with pytest.raises(ImportError, match="OpenCV"):
        ds.load_positive("face.txt", np.random.default_rng(0))
