"""The flagship workflow on the port, against the JAX package's scripts on
the CPU: `ops/resize.cv2_gaussian_blur` bit-equal to OpenCV's 8-bit
GaussianBlur, the generators of scripts/train_flagship_torch.py byte-equal
to scripts/train_flagship.py's, the scene builder and scorer of
scripts/eval_synth_scenes_torch.py equal to scripts/eval_synth_scenes.py's,
chip_smoke.py's generator digests, a tiny training run with its stop and
finalisation, and the scene evaluation of models/flagship_synth.model."""

import json
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

cv2 = pytest.importorskip("cv2")

import chip_smoke  # noqa: E402
import jda_tpu_torch  # noqa: E402
from jda_tpu_torch.ops.resize import cv2_gaussian_blur, gaussian_taps_fixed  # noqa: E402
from scripts import eval_synth_scenes as JE  # noqa: E402
from scripts import eval_synth_scenes_torch as E  # noqa: E402
from scripts import finalize_partial_model_torch as FZ  # noqa: E402
from scripts import train_flagship as J  # noqa: E402
from scripts import train_flagship_torch as F  # noqa: E402
from torch_train_util import one_torch_thread  # noqa: E402,F401 (autouse)

# SHA-256 of jda_tpu.Detector(m, rounding=True).detect_stream over the first
# two evaluation scenes (batch 8, th -3, scale 1.25; bboxes, scores and
# shapes), recorded on the CPU: the JAX package compiles that plan for
# about two minutes, so the test holds the port against the record
JAX_TWO_SCENES_SHA256 = "73bc5c8e87c63dea5685cb1ef35c32b4cc5324e0fa8efc751acf345ce28ab226"

# every sigma the generators draw: band_limit's max(0.6, 0.6 * R / 48) for
# make_face's R in [48, 144] (scenes: faces of 56-159 px, R up to 477),
# make_near_miss's and make_hard_canvas's R in [48, 96], and make_bg's 0.9;
# then the grid 0.6, 0.65, ..., 6.0
GENERATOR_SIGMAS = sorted({max(0.6, 0.6 * (R / 48.0)) for R in range(48, 478)} | {0.6 * 1.5})
SIGMA_GRID = [float(s) for s in np.round(np.arange(0.6, 6.0001, 0.05), 2)]


@pytest.mark.parametrize("shape", [(120, 130), (84, 84), (48, 48), (37, 61), (19, 7), (1, 9)])
def test_gaussian_blur_matches_opencv(shape):
    """Bit-equal to cv2.GaussianBlur(img, (0, 0), s, s) at every sigma the
    generators draw and over the grid [0.6, 6.0], on square and odd shapes
    and on images smaller than the kernel's radius (18 at sigma 6)."""
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    bad = []
    for s in GENERATOR_SIGMAS + SIGMA_GRID:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        want = cv2.GaussianBlur(img, (0, 0), sigmaX=s, sigmaY=s)
        got = cv2_gaussian_blur(img, s)
        if got.dtype != np.uint8 or not np.array_equal(got, want):
            bad.append((s, int(np.abs(got.astype(int) - want).max())))
    assert not bad, bad


def test_gaussian_taps_quantised_by_error_diffusion():
    """The taps sum to 256 and are symmetric; plain rounding with a centre
    fix-up differs at sigma 2 (the trap the error diffusion avoids)."""
    for s in (0.6, 0.9, 2.0, 6.0):
        k = gaussian_taps_fixed(s)
        assert len(k) == (int(np.rint(6 * s + 1)) | 1)
        assert k.sum() == 256 and np.array_equal(k, k[::-1])
    k = gaussian_taps_fixed(2.0)
    x = np.arange(len(k)) - len(k) // 2
    g = np.exp(-(x * x) / (2 * 4.0))
    naive = np.rint(g / g.sum() * 256).astype(int)
    naive[len(k) // 2] += 256 - naive.sum()
    assert not np.array_equal(naive, k)
    with pytest.raises(ValueError):
        cv2_gaussian_blur(np.zeros((4, 4), np.int32), 1.0)


@pytest.mark.parametrize("gen", ["make_face", "make_bg", "make_near_miss", "make_hard_canvas"])
def test_generators_match_the_jax_script(gen):
    """Each generator byte-equal to scripts/train_flagship.py's over several
    seeds (and difficulties and modes), the random stream left alike."""
    for seed in range(4):
        if gen == "make_face":
            cases = [((48,), {}), ((80,), {}), ((48,), {"windowed": False})]
        elif gen == "make_bg":
            cases = [((), {}), ((480,), {})]
        elif gen == "make_near_miss":
            cases = [((48, d, mode), {}) for d in (0.0, 0.5, 1.0, 1.7) for mode in range(5)]
            cases.append(((48, 0.3), {}))  # mode drawn
        else:
            cases = [((48, d), {}) for d in (0.0, 0.5, 1.0, 1.6, 2.0)]
        for args, kw in cases:
            ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
            a = getattr(J, gen)(ra, *args, **kw)
            b = getattr(F, gen)(rb, *args, **kw)
            a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
            for x, y in zip(a, b):
                if isinstance(x, np.ndarray):
                    assert x.dtype == y.dtype and np.array_equal(x, y), (gen, seed, args, kw)
                else:
                    assert x == y, (gen, seed, args, kw)
            assert ra.integers(1 << 62) == rb.integers(1 << 62)
    assert np.array_equal(J.CANON27, F.CANON27)


def test_build_scenes_and_score_at_match_the_jax_script():
    """The 24 evaluation scenes and their truths are byte-equal to the JAX
    script's (cv2.resize there, cv2_resize here), and score_at gives the
    same sweep over the same detections."""
    sa, ga = JE.build_scenes(np.random.default_rng(123), E.N_SCENES)
    sb, gb = E.build_scenes(np.random.default_rng(123), E.N_SCENES)
    assert all(np.array_equal(x, y) for x, y in zip(sa, sb))
    for (ba, la), (bb, lb) in zip(ga, gb):
        assert ba == bb and all(np.array_equal(x, y) for x, y in zip(la, lb))
    # detections around the truths: matches, misses, duplicates, off boxes
    rng = np.random.default_rng(5)
    results = []
    for boxes, lms in ga:
        bb, sc, sh = [], [], []
        for (x0, y0, w), lm in zip(boxes, lms):
            for _ in range(2):
                d = rng.integers(-w // 3, w // 3 + 1, 2)
                bb.append((x0 + d[0], y0 + d[1], w + rng.integers(-8, 9)))
                sc.append(rng.uniform(-3.5, 4.5))
                sh.append(lm + rng.normal(0, 2, lm.shape))
        bb.append((600, 440, 30))
        sc.append(rng.uniform(-3, 3))
        sh.append(np.zeros(54))
        results.append(jda_tpu_torch.DetectionResult(
            len(bb), 27, np.asarray(bb, np.int32), np.asarray(sh, np.float32),
            np.asarray(sc, np.float32)))
    c = F.flagship_config()
    for th in E.SWEEP:
        assert E.score_at(results, ga, th, c.left_pupils, c.right_pupils) == \
            JE.score_at(results, ga, th, c.left_pupils, c.right_pupils)
    assert E.sweep(results, ga) == [
        JE.score_at(results, ga, th, c.left_pupils, c.right_pupils) for th in E.SWEEP]


def test_chip_smoke_digests_are_the_jax_scripts():
    """Phase 22's constants equal the digests of scripts/train_flagship.py's
    output with OpenCV, and the port's output has the same digests."""
    want = chip_smoke.GENERATOR_DIGESTS
    scenes = JE.build_scenes(np.random.default_rng(123), E.N_SCENES)
    assert chip_smoke.generator_digests(J, scenes) == want
    scenes = E.build_scenes(np.random.default_rng(123), E.N_SCENES)
    assert chip_smoke.generator_digests(F, scenes) == want


def test_flagship_config_matches_the_jax_script():
    a = J.flagship_config()
    b = F.flagship_config()
    assert isinstance(b, jda_tpu_torch.Config)
    assert {k: v for k, v in vars(a).items()} == {k: v for k, v in vars(b).items()}


def test_tiny_main_writes_model_and_stats(tmp_path):
    """main() on the CPU: one stage of two carts on 48 faces writes the
    model, the stage model and the stats JSON with the JAX script's keys."""
    out = tmp_path / "run"
    stats = F.main(["--device", "cpu", "--stages", "1", "--k", "2", "--n-pos", "48",
                    "--mining-max-batches", "2", "--out", str(out)])
    with open(os.path.join(ROOT, "models", "flagship_synth.stats.json")) as f:
        jax_keys = set(json.load(f))
    with open(out / "flagship_synth.stats.json") as f:
        written = json.load(f)
    assert jax_keys <= set(written) and written == json.loads(json.dumps(stats))
    assert written["carts_trained"] == 2 and not written["stopped"]
    assert written["T"] == 1 and written["K"] == 2 and len(written["per_stage_sec"]) == 1
    assert written["mining"] and written["mining"][0]["scan"]["screened"] > 0
    m = jda_tpu_torch.load_model(str(out / "flagship_synth.model"))
    assert (m.T, m.K, m.landmark_n, m.stage_idx, m.cart_idx) == (1, 2, 27, 1, -1)
    assert np.any(m.W[0])
    s1 = jda_tpu_torch.load_model(str(out / "flagship_synth.stage1.model"))
    assert np.array_equal(s1.leaf_scores, m.leaf_scores)


def test_stop_and_finalize(tmp_path):
    """--max-seconds stops before a cart and writes the partial model at the
    last trained cart; finalize turns the untrained carts into pass-through
    carts, keeps the cursor of the stage that has no regression yet, and
    the result loads and equals that rule applied by hand.  The JAX
    package's script refuses the same partial model."""
    out = tmp_path / "run"
    args = ["--device", "cpu", "--k", "2", "--n-pos", "40", "--mining-max-batches", "2"]
    full = F.main(args + ["--stages", "2", "--out", str(out)])
    assert full["cursor"] == [2, -1]
    stop = F.main(args + ["--stages", "1", "--out", str(tmp_path / "stop"),
                          "--max-seconds", "0"])
    assert stop["stopped"] and stop["carts_trained"] == 0 and stop["cursor"] == [0, -1]
    p = jda_tpu_torch.load_model(str(tmp_path / "stop" / "flagship_synth.partial.model"))
    assert (p.stage_idx, p.cart_idx) == (0, -1)
    assert not os.path.exists(tmp_path / "stop" / "flagship_synth.model")
    partial = out / "flagship_synth.partial.model"

    # a partial model mid-stage: the full run's model with stage 2 cut
    # after its first cart (W of stage 2 not yet solved)
    m = jda_tpu_torch.load_model(str(out / "flagship_synth.model"))
    m.W[1] = 0.0
    m.stage_idx, m.cart_idx = 1, 0
    jda_tpu_torch.save_model(m, str(partial))
    dst = str(out / "final.model")
    FZ.finalize(str(partial), dst)
    f = jda_tpu_torch.load_model(dst)
    assert (f.stage_idx, f.cart_idx) == (1, 0)
    np.testing.assert_array_equal(f.leaf_scores[1, 1:], 0.0)
    assert np.any(f.leaf_scores[1, 0])
    np.testing.assert_array_equal(f.cart_th[1, 1:], -np.inf)
    np.testing.assert_array_equal(f.std[1, 1:], 1.0)
    np.testing.assert_array_equal(f.leaf_scores[:, :1], m.leaf_scores[:, :1])
    np.testing.assert_array_equal(f.leaf_scores[0], m.leaf_scores[0])
    from jda_tpu.params import load_model as jax_load

    assert (jax_load(dst).stage_idx, jax_load(dst).cart_idx) == (1, 0)
    import scripts.finalize_partial_model as JF

    with pytest.raises(ValueError, match="regression"):
        JF.finalize(str(partial), str(out / "final_jax.model"))
    # a partial model at a stage boundary finalizes to a complete cursor,
    # byte-equal to the JAX package's script
    m = jda_tpu_torch.load_model(str(out / "flagship_synth.model"))
    m.leaf_scores[1] = 0.0
    m.W[1] = 0.0
    m.stage_idx, m.cart_idx = 1, -1
    jda_tpu_torch.save_model(m, str(partial))
    FZ.finalize(str(partial), dst)
    JF.finalize(str(partial), str(out / "final_jax.model"))
    with open(dst, "rb") as a, open(out / "final_jax.model", "rb") as b:
        assert a.read() == b.read()
    assert jda_tpu_torch.load_model(dst).stage_idx == 2


def test_scene_evaluation_of_the_shipped_model(tmp_path, monkeypatch):
    """The script's evaluation of models/flagship_synth.model on the first
    two scenes on the CPU: the detections equal jda_tpu's record, and the
    written sweep is the JAX script's score_at over them.  The script
    refuses to write models/scene_eval.json."""
    seen = []

    class Recording(jda_tpu_torch.Detector):
        def detect_stream(self, *a, **kw):
            seen.append(super().detect_stream(*a, **kw))
            return seen[-1]

    monkeypatch.setattr(jda_tpu_torch, "Detector", Recording)
    monkeypatch.setattr(E, "N_SCENES", 2)
    monkeypatch.delenv("JDA_TPU_EVAL_SCALE", raising=False)
    out = tmp_path / "eval.json"
    model = os.path.join(ROOT, "models", "flagship_synth.model")
    payload = E.main([model, str(out), "--device", "cpu"])
    (res,) = seen
    assert chip_smoke._sha256(
        [x for r in res for x in (np.asarray(r.bboxes), np.asarray(r.scores),
                                  np.asarray(r.shapes))]) == JAX_TWO_SCENES_SHA256
    _, gt = JE.build_scenes(np.random.default_rng(123), 2)
    c = J.flagship_config()
    with open(out) as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(payload))
    assert written["sweep"] == [JE.score_at(res, gt, th, c.left_pupils, c.right_pupils)
                                for th in E.SWEEP]
    assert written["scenes"] == 2 and written["ladder_scale"] == 1.25
    with pytest.raises(ValueError, match="JAX package"):
        E.main([model, os.path.join(ROOT, "models", "scene_eval.json"), "--device", "cpu"])
