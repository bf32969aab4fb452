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

`cv2_resize` is the port's model of `cv2.resize(img, (w, h))` (8-bit,
INTER_LINEAR), bit-exact on whole-image shrinks as well as on patches; the
C++-semantics path (cascador.py) calls it wherever the JAX package calls
OpenCV, so the port needs no OpenCV.  `cv2_gaussian_blur` is the same for
`cv2.GaussianBlur(img, (0, 0), sigma, sigma)` on 8-bit images, which the
flagship workflow's generators call (scripts/train_flagship_torch.py).
`cv2_gaussian_blur_f32` is `cv2.GaussianBlur` on float32 images and
`cv2_resize_cubic` is `cv2.resize(..., interpolation=cv2.INTER_CUBIC)` on
8-bit images, as the held-out evaluation (scripts/eval_holdout_torch.py)
calls them.
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=512)
def cv2_taps(
    src_n: int, dst_n: int, clamp_frac: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Fixed-point taps (s0, s1, c0, c1) of one axis of OpenCV's 8-bit
    INTER_LINEAR resize, computed as resize.cpp computes them: scale =
    1 / (dst / src) in double, the source coordinate
    fx = (float)((i + 0.5) * scale - 0.5), sx = floor(fx), fx -= sx, then
    c0 = cvRound((1.f - fx) * 2048) and c1 = cvRound(fx * 2048) in float32
    (cvRound rounds half to even).

    Along x (`clamp_frac`) a tap left of the image or on its last pixel
    takes that pixel alone (fx = 0); along y the coefficients keep fx and
    only the two source rows are clamped to the image.  The arrays are
    read-only: they are cached."""
    scale = 1.0 / (dst_n / src_n)
    f = ((np.arange(dst_n, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    s0 = np.floor(f).astype(np.int64)
    f = f - s0.astype(np.float32)
    if clamp_frac:
        f = np.where((s0 < 0) | (s0 >= src_n - 1), np.float32(0), f)
        s0 = np.clip(s0, 0, src_n - 1)
        s1 = np.minimum(s0 + 1, src_n - 1)
    else:
        s0, s1 = np.clip(s0, 0, src_n - 1), np.clip(s0 + 1, 0, src_n - 1)
    one, coef = np.float32(1.0), np.float32(2048.0)
    c0 = np.rint((one - f) * coef).astype(np.int32)
    c1 = np.rint(f * coef).astype(np.int32)
    out = (s0.astype(np.intp), s1.astype(np.intp), c0, c1)
    for a in out:
        a.flags.writeable = False
    return out


def cv2_resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """`cv2.resize(img, (w, h))` for uint8 images, INTER_LINEAR, bit for bit.

    The horizontal pass accumulates short coefficients (scale 2^11) into
    int32, the vertical pass is `cv_fixed_combine`, as in
    `resize_bilinear_cv_exact`; the taps differ from that function's: they
    are OpenCV's float32 source coordinates (`cv2_taps`), where
    `cv_linear_taps_fixed` maps in float64 and is off by one on about 0.2 %
    of a whole-image shrink's pixels.  `img` is [..., H, W]: the last two
    axes are resized, so a stack of patches takes one call."""
    if img.dtype != np.uint8 or img.ndim < 2:
        raise ValueError("cv2_resize: img must be a uint8 array of at least 2 axes")
    if w < 1 or h < 1:
        raise ValueError(f"cv2_resize: empty output size {(w, h)}")
    xs0, xs1, xc0, xc1 = cv2_taps(img.shape[-1], w, True)
    ys0, ys1, yc0, yc1 = cv2_taps(img.shape[-2], h, False)
    t = img[..., xs0].astype(np.int32) * xc0 + img[..., xs1].astype(np.int32) * xc1
    out = cv_fixed_combine(
        t[..., ys0, :], t[..., ys1, :], yc0[:, None], yc1[:, None]
    )
    return np.clip(out, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=256)
def gaussian_taps_fixed(sigma: float) -> np.ndarray:
    """OpenCV's 8-bit Gaussian kernel for `sigma`, in units of 2^-8.

    ksize = cvRound(6 * sigma + 1) | 1.  The float64 taps are
    exp(x^2 * (-0.125 / sigma^2)) at x = 1 - n, 3 - n, ..., normalised to sum
    1 (getGaussianKernelBitExact); they are quantised by error diffusion from
    the outermost tap inward: v = round(k * 256 + err), err = that sum - v,
    each value mirrored to both sides, and the centre takes 256 - 2 * sum
    (getGaussianKernelFixedPoint_ED).  Rounding each tap on its own and
    fixing the centre is off by up to 2 grey levels (sigma 1.85, 2, 3, ...).
    The array is read-only: it is cached."""
    n = int(np.rint(sigma * 6 + 1)) | 1
    h = n // 2
    x = np.arange(1 - n, 0, 2, dtype=np.int64)[:h]
    vals = np.exp((x * x).astype(np.float64) * (-0.125 / (sigma * sigma)))
    total = 0.0
    for v in vals:  # softdouble sums one tap after another
        total += float(v)
    k = vals * (1.0 / (total * 2.0 + 1.0))
    taps = np.zeros(n, np.int32)
    err, acc = 0.0, 0
    for i in range(h):
        adj = float(k[i]) * 256.0 + err
        v = int(np.rint(adj))
        err = adj - float(v)
        taps[i] = taps[n - 1 - i] = v
        acc += v
    taps[h] = 256 - 2 * acc
    taps.flags.writeable = False
    return taps


def _smooth_rows(a: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """Symmetric integer filter along the last axis over a reflect-101
    border (numpy's "reflect"), exact in int32."""
    n = len(taps)
    h = n // 2
    W = a.shape[-1]
    pad = [(0, 0)] * (a.ndim - 1) + [(h, h)]
    p = np.pad(a, pad, mode="reflect")
    out = int(taps[h]) * p[..., h : h + W]
    for j in range(h):
        out = out + int(taps[j]) * (p[..., j : j + W] + p[..., n - 1 - j : n - 1 - j + W])
    return out


def cv2_gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)` for 2-D
    uint8 images, bit for bit (OpenCV's fixed-point path for 8-bit images,
    BORDER_REFLECT_101).

    The row pass sums pixel * tap exactly (8 fractional bits), the column
    pass sums those rows * tap exactly (16 fractional bits), and the result
    is (acc + 2^15) >> 16, saturated to uint8.  Numpy, on the host."""
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("cv2_gaussian_blur: img must be a 2-D uint8 array")
    if not sigma > 0:
        raise ValueError(f"cv2_gaussian_blur: sigma must be positive, not {sigma}")
    taps = gaussian_taps_fixed(float(sigma))
    rows = _smooth_rows(img.astype(np.int32), taps)
    acc = _smooth_rows(rows.T, taps).T
    return np.clip((acc + (1 << 15)) >> 16, 0, 255).astype(np.uint8)


def _fma_f32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add, a * b + c with one rounding, in numpy.

    The product of two float32 values is exact in float64; the float64 sum
    can round once more, and its rounding to float32 then errs only when it
    lands on a float32 midpoint: the exact remainder (TwoSum) decides that
    case."""
    p = np.float64(a) * np.float64(b)
    c = np.float64(c)
    s = p + c
    bb = s - p
    e = (p - (s - bb)) + (c - bb)  # s + e == p + c exactly
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    other = np.where(s > r64, np.nextafter(r, np.float32(np.inf)),
                     np.nextafter(r, np.float32(-np.inf)))
    tie = (s == (r64 + other.astype(np.float64)) * 0.5) & (e != 0)
    fixed = np.where(e > 0, np.maximum(r, other), np.minimum(r, other))
    return np.where(tie, fixed, r).astype(np.float32)


def gaussian_kernel_f32(sigma: float) -> np.ndarray:
    """OpenCV's Gaussian kernel for float32 images (getGaussianKernel with
    CV_32F): n = round(8 sigma + 1) | 1 taps, exp(x^2 * (-0.125 / sigma^2))
    at x = 1 - n, 3 - n, ..., normalised in double to sum 1
    (getGaussianKernelBitExact), then rounded to float32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    h = n // 2
    x = np.arange(1 - n, 0, 2, dtype=np.int64)[:h]
    vals = np.exp((x * x).astype(np.float64) * (-0.125 / (sigma * sigma)))
    total = 0.0
    for v in vals:  # softdouble sums one tap after another
        total += float(v)
    mul = 1.0 / (total * 2.0 + 1.0)
    k = np.empty(n, np.float64)
    k[:h] = vals * mul
    k[h + 1:] = k[:h][::-1]
    k[h] = mul
    return k.astype(np.float32)


def cv2_gaussian_blur_f32(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)` for 2-D
    float32 images, bit for bit (OpenCV's separable filter for float32,
    BORDER_REFLECT_101; the build's AVX2 paths, which IPP does not replace).

    The row pass sums tap 0 to n-1 in float32, fused multiply-adds over the
    columns its 4-wide vector loop covers and a multiply, then an add, over
    the rest (RowVec_32f); the column pass starts from the centre tap and
    adds (row[+k] + row[-k]) * tap[k] outward, fused over the columns its
    8-wide vector loop covers (SymmColumnVec_32f).  Numpy, on the host."""
    if img.dtype != np.float32 or img.ndim != 2:
        raise ValueError("cv2_gaussian_blur_f32: img must be a 2-D float32 array")
    if not sigma > 0:
        raise ValueError(f"cv2_gaussian_blur_f32: sigma must be positive, not {sigma}")
    k = gaussian_kernel_f32(float(sigma))
    n, h = len(k), len(k) // 2
    H, W = img.shape
    p = np.pad(img, ((0, 0), (h, h)), mode="reflect")
    fused = (W // 4) * 4
    rows = p[:, 0:W] * k[0]
    for j in range(1, n):
        win = p[:, j:j + W]
        rows[:, :fused] = _fma_f32(win[:, :fused], k[j], rows[:, :fused])
        rows[:, fused:] += win[:, fused:] * k[j]
    q = np.pad(rows, ((h, h), (0, 0)), mode="reflect")
    fused = (W // 8) * 8
    out = q[h:h + H] * k[h]
    for j in range(1, h + 1):
        pair = q[h + j:h + j + H] + q[h - j:h - j + H]
        out[:, :fused] = _fma_f32(pair[:, :fused], k[h + j], out[:, :fused])
        out[:, fused:] += pair[:, fused:] * k[h + j]
    return out


# the Keys cubic (A = -0.75) as polynomials in the fraction t, for the taps
# at -1, 0, 1, 2: coefficients of t^3, t^2, t, 1
_CUBIC = ((-0.75, 1.5, -0.75, 0.0), (1.25, -2.25, 0.0, 1.0),
          (-1.25, 1.5, 0.75, 0.0), (0.75, -0.75, 0.0, 0.0))


def cubic_taps(dst: int, src: int):
    """The taps of one axis of `cv2_resize_cubic`: source indices [dst, 4]
    (clamped: border replicate), float32 weights [dst, 4] and whether each
    output has a clamped tap [dst].

    The source coordinate is (d + 0.5) * src / dst - 0.5 in double; its
    fraction goes through float32 as float32(1 + float32(t)) - 1 (so on a
    grid of 2^-23), and each weight is the cubic at that fraction in double,
    rounded to float32."""
    d = np.arange(dst, dtype=np.float64)
    fx = (d + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx)
    t32 = (fx - sx).astype(np.float32)
    t = (np.float32(1) + t32).astype(np.float32).astype(np.float64) - 1.0
    w = np.stack([((a * t + b) * t + c) * t + e for a, b, c, e in _CUBIC], -1)
    s = sx.astype(np.int64)
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, w.astype(np.float32), (s - 1 < 0) | (s + 2 > src - 1)


def _pairs(t, w):
    """(t0 * w0 + t1 * w1) + (t2 * w2 + t3 * w3) in float32."""
    return (t[0] * w[0] + t[1] * w[1]) + (t[2] * w[2] + t[3] * w[3])


def _pairs_fma(t, w):
    """fma(t0, w0, t1 * w1) + fma(t2, w2, t3 * w3) in float32."""
    return _fma_f32(t[0], w[0], t[1] * w[1]) + _fma_f32(t[2], w[2], t[3] * w[3])


def _chain_fma(t, w):
    """fma(t3, w3, fma(t2, w2, fma(t1, w1, t0 * w0))) in float32."""
    acc = t[0] * w[0]
    for k in (1, 2, 3):
        acc = _fma_f32(t[k], w[k], acc)
    return acc


def _cubic_taps_fixed(dst: int, src: int):
    """The taps of one axis of OpenCV's own cubic resize: source indices
    [dst, 4] (clamped: border replicate) and the weights [dst, 4] in
    fixed point (x 2048, rounded to nearest even).  The source coordinate
    is (d + 0.5) / (dst / src) - 0.5 in double, rounded to float32, and the
    weights are the cubic at its fraction in float32 (interpolateCubic)."""
    d = np.arange(dst, dtype=np.float64)
    f = ((d + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = f - s.astype(np.float32)
    A, one = np.float32(-0.75), np.float32(1)
    a5, a8, a4 = np.float32(-3.75), np.float32(-6), np.float32(-3)  # 5A, 8A, 4A
    a2, a3 = np.float32(1.25), np.float32(2.25)  # A + 2, A + 3
    x1, mx = x + one, one - x
    c0 = ((A * x1 - a5) * x1 + a8) * x1 - a4
    c1 = (a2 * x - a3) * x * x + one
    c2 = (a2 * mx - a3) * mx * mx + one
    c = np.stack([c0, c1, c2, one - c0 - c1 - c2], -1)
    idx = np.clip(s[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, np.rint(c * np.float32(2048)).astype(np.int64)


def _resize_cubic_fixed(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """OpenCV's own 8-bit cubic resize (resizeGeneric_ with HResizeCubic
    and VResizeCubic), the answer of `cv2.resize(..., INTER_CUBIC)` where
    IPP is not taken.  The row pass sums the four taps in integers; the
    column pass takes the first multiple of 8 columns in float32 (its
    SSE vector loop: r0 b0 + (r1 b1 + (r2 b2 + r3 b3)) with b = beta /
    2048^2, rounded to nearest even) and the rest in integers, (sum +
    2^21) >> 22; both saturate."""
    H, W = img.shape
    xi, xa = _cubic_taps_fixed(w, W)
    yi, yb = _cubic_taps_fixed(h, H)
    a = img.astype(np.int64)
    rows = sum(a[:, xi[:, k]] * xa[:, k] for k in range(4))
    r = [rows[yi[:, k]] for k in range(4)]
    out = (sum(r[k] * yb[:, k:k + 1] for k in range(4)) + (1 << 21)) >> 22
    v = (w // 8) * 8
    b = [yb[:, k:k + 1].astype(np.float32) * np.float32(1 / 2048 ** 2) for k in range(4)]
    f = [r[k][:, :v].astype(np.float32) * b[k] for k in range(4)]
    out[:, :v] = np.rint(f[0] + (f[1] + (f[2] + f[3])))
    return np.clip(out, 0, 255).astype(np.uint8)


def cv2_resize_cubic(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """`cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC)` for 2-D
    uint8 images, as OpenCV's builds with Intel IPP compute it (IPP's float
    cubic resize, which OpenCV's IPP HAL takes in place of its own
    fixed-point resize).  Numpy, on the host.

    Rows first: each output column sums its four taps in float32, as
    (p0 w0 + p1 w1) + (p2 w2 + p3 w3) where every tap lies inside the row,
    and as p0 w0 followed by fused multiply-adds of p1 w1, p2 w2 and p3 w3,
    in that order, where a tap is clamped; the column pass sums four such
    rows by fma(r0, w0, r1 w1) + fma(r2, w2, r3 w3) at every output; the
    result is rounded to nearest even and saturated.  This is OpenCV's
    answer on every pixel of the held-out script's 24 backgrounds (12x12 up
    to 640x480) and of the shapes in tests/test_torch_holdout.py.  On other
    shapes a few columns just short of the right-hand border take another
    order in IPP (at some, taps (0, 2) and (1, 3) paired): over random
    images about one output in 10^7 there is 1 off.

    OpenCV keeps IPP off a source with a side under 4 pixels, and its own
    fixed-point resize answers there (`_resize_cubic_fixed`).
    """
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError("cv2_resize_cubic: img must be a 2-D uint8 array")
    if min(img.shape) < 4:
        return _resize_cubic_fixed(img, w, h)
    a = img.astype(np.float32)
    H, W = a.shape
    xi, xw, clamped = cubic_taps(w, W)
    yi, yw, _ = cubic_taps(h, H)
    cols = [a[:, xi[:, k]] for k in range(4)]
    wx = [xw[None, :, k] for k in range(4)]
    rows = np.where(clamped, _chain_fma(cols, wx), _pairs(cols, wx))
    wy = [yw[:, k:k + 1] for k in range(4)]
    out = _pairs_fma([rows[yi[:, k]] for k in range(4)], wy)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


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
