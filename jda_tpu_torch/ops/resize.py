"""Image resize + detection pyramid (numpy, on the host).

The port's own copy of the JAX package's ops/resize.py, function for
function and bit for bit.

`resize_bilinear_c` reproduces the reference C library's bilinear resize
bit-for-bit (c/jda.c:203-230): source coordinate ratio
(src-1)/dst computed in float32, source index truncated, fractional weights
in float32, result truncated to uint8.  The pyramid is built once per
image on the host, which is cheap.

`pyramid_c` builds the o/h/q triple exactly as jdaDetect does
(c/jda.c:443-457): h = resize to (int(w/sqrt2), int(h/sqrt2)), q = resize to
(w//2, h//2), both from the original.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np


def resize_bilinear_c(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bilinear resize with the C library's exact semantics (numpy, host)."""
    assert img.dtype == np.uint8 and img.ndim == 2
    src_h, src_w = img.shape
    x_ratio = np.float32(src_w - 1) / np.float32(w)
    y_ratio = np.float32(src_h - 1) / np.float32(h)
    j = np.arange(w, dtype=np.float32)
    i = np.arange(h, dtype=np.float32)
    xf = x_ratio * j  # float32
    yf = y_ratio * i
    x = xf.astype(np.int32)  # trunc toward zero (non-negative -> floor)
    y = yf.astype(np.int32)
    x_diff = (xf - x.astype(np.float32)).astype(np.float32)
    y_diff = (yf - y.astype(np.float32)).astype(np.float32)

    a = img[y[:, None], x[None, :]].astype(np.float32)
    b = img[y[:, None], x[None, :] + 1].astype(np.float32)
    c = img[y[:, None] + 1, x[None, :]].astype(np.float32)
    d = img[y[:, None] + 1, x[None, :] + 1].astype(np.float32)

    one = np.float32(1.0)
    xd = x_diff[None, :]
    yd = y_diff[:, None]
    # same multiply/add structure as c/jda.c:223-226 (float32 throughout)
    out = (
        a * (one - xd) * (one - yd)
        + b * xd * (one - yd)
        + c * (one - xd) * yd
        + d * xd * yd
    )
    return out.astype(np.uint8)  # (unsigned char) cast = trunc


def pyramid_c(gray: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """o/h/q pyramid with jdaDetect's exact dimensions (c/jda.c:450-457)."""
    hgt, wid = gray.shape
    r = np.float32(1.0) / np.float32(math.sqrt(2.0))
    hw = int(np.float32(wid) * r)
    hh = int(np.float32(hgt) * r)
    img_h = resize_bilinear_c(gray, hw, hh)
    img_q = resize_bilinear_c(gray, wid // 2, hgt // 2)
    return gray, img_h, img_q


def resize_bilinear_cv(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """OpenCV INTER_LINEAR-compatible resize (pixel-center alignment).

    Used by the C++ training path (cv::resize in data.cpp:630-632,
    cascador.cpp:243-245).  OpenCV maps dst (i, j) to
    src ((i+0.5)*sy-0.5, (j+0.5)*sx-0.5), clamps, and rounds the blended
    value to nearest.  We match that formula (OpenCV's fixed-point
    interpolation may differ in the last bit; training does not require
    bit parity with OpenCV — the model format, not the corpus, is the
    contract).
    """
    assert img.dtype == np.uint8 and img.ndim == 2
    src_h, src_w = img.shape
    sx = src_w / w
    sy = src_h / h
    jf = (np.arange(w, dtype=np.float64) + 0.5) * sx - 0.5
    if_ = (np.arange(h, dtype=np.float64) + 0.5) * sy - 0.5
    jf = np.clip(jf, 0, src_w - 1)
    if_ = np.clip(if_, 0, src_h - 1)
    x0 = np.clip(np.floor(jf).astype(np.int64), 0, src_w - 1)
    y0 = np.clip(np.floor(if_).astype(np.int64), 0, src_h - 1)
    x1 = np.minimum(x0 + 1, src_w - 1)
    y1 = np.minimum(y0 + 1, src_h - 1)
    xd = jf - x0
    yd = if_ - y0
    a = img[y0[:, None], x0[None, :]].astype(np.float64)
    b = img[y0[:, None], x1[None, :]].astype(np.float64)
    c = img[y1[:, None], x0[None, :]].astype(np.float64)
    d = img[y1[:, None], x1[None, :]].astype(np.float64)
    out = (
        a * (1 - xd[None, :]) * (1 - yd[:, None])
        + b * xd[None, :] * (1 - yd[:, None])
        + c * (1 - xd[None, :]) * yd[:, None]
        + d * xd[None, :] * yd[:, None]
    )
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def cv_linear_taps_fixed(
    src_n: int, dst_n: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-output-index fixed-point taps of OpenCV's 8-bit INTER_LINEAR
    resize along one axis: (s0, s1, c0, c1) with
    out-of-pass value = c0*src[s0] + c1*src[s1], coefficients scaled by
    2048 (INTER_RESIZE_COEF_SCALE).

    OpenCV maps dst i to src (i+0.5)*src_n/dst_n - 0.5, floors, clamps the
    fraction to 0 at both borders, and rounds each coefficient to short
    independently (cvRound = round half to even).
    """
    src = (np.arange(dst_n, dtype=np.float64) + 0.5) * (src_n / dst_n) - 0.5
    s0 = np.floor(src).astype(np.int64)
    fx = src - s0
    fx = np.where(s0 < 0, 0.0, fx)
    s0 = np.maximum(s0, 0)
    fx = np.where(s0 >= src_n - 1, 0.0, fx)
    s0 = np.minimum(s0, src_n - 1)
    c1 = np.rint(fx * 2048.0).astype(np.int32)
    c0 = np.rint((1.0 - fx) * 2048.0).astype(np.int32)
    s1 = np.minimum(s0 + 1, src_n - 1)
    return s0.astype(np.int32), s1.astype(np.int32), c0, c1


def cv_fixed_combine(t0, t1, b0, b1):
    """OpenCV's 8u vertical-pass fixed-point cast, exactly as the SIMD
    VResizeLinearVec_32s8u computes it: inputs t are horizontal-pass
    accumulators (c0*p0 + c1*p1, scale 2^11, int32); output is the u8
    pixel value as int32:  (((b0*(t0>>4))>>16) + ((b1*(t1>>4))>>16) + 2) >> 2.
    Works on numpy arrays and torch tensors (>> is arithmetic; all values
    >= 0)."""
    return (((b0 * (t0 >> 4)) >> 16) + ((b1 * (t1 >> 4)) >> 16) + 2) >> 2


def resize_bilinear_cv_exact(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """Bit-exact OpenCV INTER_LINEAR 8-bit resize (host reference).

    Reproduces cv2.resize(img, (w, h))'s fixed-point pipeline: horizontal
    pass accumulates short coefficients (scale 2^11) into int32, the
    vertical pass applies cv_fixed_combine.  Verified element-exact
    against the installed OpenCV (5.0) over random images and the
    detection-relevant size pairs; used where device code must agree with
    host cv2.resize bit-for-bit (the multi-scale method-0 patch pyramid,
    cascador.cpp:243-245)."""
    assert img.dtype == np.uint8 and img.ndim == 2
    c_s0, c_s1, c_c0, c_c1 = cv_linear_taps_fixed(img.shape[1], w)
    r_s0, r_s1, r_c0, r_c1 = cv_linear_taps_fixed(img.shape[0], h)
    t = img[:, c_s0].astype(np.int32) * c_c0 + img[:, c_s1].astype(np.int32) * c_c1
    out = cv_fixed_combine(t[r_s0], t[r_s1], r_c0[:, None], r_c1[:, None])
    return np.clip(out, 0, 255).astype(np.uint8)


def stack_pyramid(
    imgs: Tuple[np.ndarray, ...]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate pyramid levels into one flat uint8 buffer.

    Returns (flat [sum(h*w)], offsets [n], strides [n]) so the cascade kernel
    addresses any level with a single gather:
    flat_idx = offsets[s] + y * strides[s] + x.
    """
    offsets = np.zeros(len(imgs), np.int32)
    strides = np.zeros(len(imgs), np.int32)
    pos = 0
    flats = []
    for s, im in enumerate(imgs):
        offsets[s] = pos
        strides[s] = im.shape[1]
        flats.append(im.reshape(-1))
        pos += im.size
    return np.concatenate(flats), offsets, strides
