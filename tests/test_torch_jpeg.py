"""jda_tpu_torch.jpeg against OpenCV (libjpeg-turbo) on the CPU: the
decoder equals OpenCV's gray read on the in-tree data/fddb_synth JPEGs and
on OpenCV's own output, the encoder equals cv2.imencode byte for byte, and
what the codec does not model raises."""

import glob
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

cv2 = pytest.importorskip("cv2")

from jda_tpu_torch import jpeg  # noqa: E402

IN_TREE = sorted(glob.glob(os.path.join(ROOT, "data", "fddb_synth", "images", "synth", "*", "*.jpg")))
SHAPES = [(480, 640), (53, 37), (8, 8)]


def _image(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, shape).astype(np.uint8)
    if kind == "flat":
        return np.full(shape, 77, np.uint8)
    img = np.zeros(shape, np.uint8)  # a vertical edge, then a diagonal one
    img[:, shape[1] // 2:] = 255
    img[np.tril_indices(min(shape))] = 30
    return img


def _cv2_gray(data):
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


def test_decode_in_tree_jpegs_equal_opencv():
    """All 48 in-tree JPEGs decode to OpenCV's gray read, pixel for pixel
    (the reader of jda_tpu/fddb.py)."""
    assert len(IN_TREE) == 48
    bad = []
    for path in IN_TREE:
        want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2GRAY)
        got = jpeg.imread_gray(path)
        if got.dtype != np.uint8 or not np.array_equal(got, want):
            bad.append(os.path.relpath(path, ROOT))
    assert not bad, bad


@pytest.mark.parametrize("kind", ["random", "flat", "edge"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_codec_equals_opencv(shape, kind):
    """encode_gray equals cv2.imencode('.jpg') byte for byte, and
    decode_gray of OpenCV's bytes equals OpenCV's decode."""
    img = _image(kind, shape, seed=shape[0] * 7 + shape[1])
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    assert jpeg.encode_gray(img) == enc.tobytes()
    assert np.array_equal(jpeg.decode_gray(enc.tobytes()), _cv2_gray(enc.tobytes()))


def test_other_qualities_and_restart_intervals():
    """Other qualities encode alike, and OpenCV's restart intervals decode
    (DRI, RSTn markers, the predictor reset)."""
    img = _image("random", (37, 53), seed=1)
    for q in (10, 50, 75, 100):
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
        assert jpeg.encode_gray(img, quality=q) == enc.tobytes(), q
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    data = enc.tobytes()
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert np.array_equal(jpeg.decode_gray(data), _cv2_gray(data))


def test_encode_regenerated_scenes_equal_in_tree_files():
    """Fold 1's first 4 scenes, regenerated from seed 123, encode to the
    in-tree files' bytes (written by cv2.imwrite)."""
    from scripts.eval_synth_scenes_torch import build_scenes

    scenes, _ = build_scenes(np.random.default_rng(123), 4)
    for i, scene in enumerate(scenes):
        path = os.path.join(ROOT, "data", "fddb_synth", "images", "synth", "fold_01",
                            f"img_{i:03d}.jpg")
        with open(path, "rb") as f:
            assert jpeg.encode_gray(scene) == f.read(), path


def test_unsupported_jpegs_raise(tmp_path):
    """A progressive and a 3-component JPEG raise NotImplementedError
    naming what they are; a missing file reads as None; data that is not a
    JPEG raises ValueError."""
    img = _image("random", (53, 37), seed=2)
    ok, prog = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(NotImplementedError, match="progressive"):
        jpeg.decode_gray(prog.tobytes())
    ok, color = cv2.imencode(".jpg", np.dstack([img, img[::-1], img[:, ::-1]]))
    with pytest.raises(NotImplementedError, match="3 components"):
        jpeg.decode_gray(color.tobytes())
    ok, png = cv2.imencode(".png", img)
    with pytest.raises(ValueError, match="not a JPEG"):
        jpeg.decode_gray(png.tobytes())
    assert jpeg.imread_gray(str(tmp_path / "missing.jpg")) is None
    with pytest.raises(ValueError):
        jpeg.encode_gray(img.astype(np.int32))
