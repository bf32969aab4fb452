"""jda_tpu_torch.oracle against jda_tpu.oracle, the native C library and the
port's detector, on the CPU.

The oracle builds the reference C library, which is not in this
repository.  The repository's own C library (native/jda_native.c) has the
same C API and builds with the oracle's own gcc line, so these tests point
both packages' REFERENCE_C at it and build into a temporary directory.
"""

import os

import numpy as np
import pytest

from jda_tpu import oracle as JO
from jda_tpu_torch import native as TN
from jda_tpu_torch import oracle as TO
from jda_tpu_torch import params as TP
from jda_tpu_torch.detect import Detector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_C = os.path.join(ROOT, "native", "jda_native.c")
TH = -5.0


def _img(h, w, seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    return np.clip(img + rng.normal(0, 12, (h, w)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Both oracle modules on native/jda_native.c, each built into its own
    temporary directory, and a model of the reference's geometry saved as
    doubles and as floats."""
    tmp = tmp_path_factory.mktemp("oracle")
    m = TP.synthetic_model(T=TO.T, K=TO.K, landmark_n=TO.LANDMARK_N,
                           tree_depth=TO.TREE_DEPTH, seed=21, reject_rate=0.10)
    for dtype in ("double", "float"):
        TP.save_model(m, str(tmp / f"{dtype}.model"), dtype=dtype)
    with pytest.MonkeyPatch.context() as mp:
        for mod, sub in ((TO, "torch"), (JO, "jax")):
            mp.setattr(mod, "REFERENCE_C", NATIVE_C)
            mp.setattr(mod, "_BUILD_DIR", str(tmp / sub))
            mp.setattr(mod, "_lib", None)
        yield str(tmp / "double.model"), tmp


@pytest.mark.parametrize("dtype", ["double", "float"])
def test_oracle_matches_jax_oracle_and_native(built, dtype):
    path, tmp = built
    path = str(tmp / f"{dtype}.model")
    assert TO.available()
    port = TO.Oracle(path, dtype=dtype)
    assert os.path.exists(tmp / "torch" / "libjda_ref.so")
    ref = JO.Oracle(path, dtype=dtype)
    nat = TN.NativeDetector(path, dtype=dtype)
    for seed, (h, w) in ((6, (96, 128)), (7, (120, 100))):
        img = _img(h, w, seed)
        got = port.detect(img, th=TH)
        assert len(got[0]) > 0, "degenerate fixture"
        for want in (ref.detect(img, th=TH), nat.detect(img, th=TH)):
            for a, b in zip(want, got):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    nat.close()


def test_oracle_serialize_float_matches_jax_oracle(built):
    path, tmp = built
    TO.Oracle(path).serialize_float(str(tmp / "port.fmodel"))
    JO.Oracle(path).serialize_float(str(tmp / "jax.fmodel"))
    a = (tmp / "port.fmodel").read_bytes()
    assert a == (tmp / "jax.fmodel").read_bytes() and len(a) > 0
    # the float model loads back and detects as the double one does
    img = _img(96, 128, 6)
    for x, y in zip(TO.Oracle(path).detect(img, th=TH),
                    TO.Oracle(str(tmp / "port.fmodel"), "float").detect(img, th=TH)):
        np.testing.assert_array_equal(x, y)


def test_oracle_matches_cpu_detector(built):
    """The port's detector on the CPU against the oracle: identical boxes,
    scores within 2e-4, shapes within 2e-3 (tests/test_detect_parity.py's
    tolerances: the oracle is a separate C implementation)."""
    path, _ = built
    img = _img(96, 128, 6)
    ob, osh, osc = TO.Oracle(path).detect(img, th=TH)
    res = Detector(TP.load_model(path), device="cpu").detect(img, th=TH)
    assert len(ob) > 0
    np.testing.assert_array_equal(ob, res.bboxes)
    np.testing.assert_allclose(osc, res.scores, rtol=0, atol=2e-4)
    np.testing.assert_allclose(osh, res.shapes, rtol=0, atol=2e-3)


def test_available_is_false_for_a_missing_path(monkeypatch, tmp_path):
    monkeypatch.setattr(TO, "REFERENCE_C", str(tmp_path / "missing" / "jda.c"))
    assert not TO.available()
    monkeypatch.setattr(TO, "REFERENCE_C", NATIVE_C)
    assert TO.available()
