"""The flagship workflow's first step on PyTorch: train a flagship-geometry
cascade (T=5, K=540, 27 landmarks, depth 4, F=2000) on generated faces, or
resume one from a stage-end snapshot pair.

The counterpart of scripts/train_flagship.py, function for function: the
same generators (copied with their comments, which keep that script's
history), the same random streams (corpus from seed 7, background tile i
from 7,000,000 + i, near-miss i from 9,000,000 + i, hard canvas i from
9,500,000 + i), the same factory registrations, a partial model every 60
carts, a model per stage and the same stats JSON.  `band_limit` runs on
`ops/resize.cv2_gaussian_blur`, so the bytes equal OpenCV's and no OpenCV
is needed.  The port runs on CUDA unless `--device cpu` is given.

Usage:
  python scripts/train_flagship_torch.py [--n-pos 16384] [--out models/flagship_torch]
  python scripts/train_flagship_torch.py \
      --resume models/snapshots/jda_tmp_20260819-142743_stage_5_cart_0.model \
      --resume-data models/snapshots/jda_data_20260819-142743_stage_5_cart_0.data \
      [--max-seconds 3000]

`--max-seconds` stops training before the first cart that would start past
that many seconds: the model so far is written as
flagship_synth.partial.model (scripts/finalize_partial_model_torch.py makes
it deployable) and the stats JSON says where it stopped.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from jda_tpu_torch.ops.resize import cv2_gaussian_blur


# 27-landmark canonical template (normalized [0,1] coords, face-like):
# brows (0-5), eyes (6-11; pupils at 8 and 13 per the shipped config's
# left/right pupil ids [9]/[14] 1-offset), nose (12-16), mouth (17-23),
# chin (24-26)
CANON27 = np.array([
    [0.22, 0.30], [0.30, 0.26], [0.38, 0.30],      # left brow
    [0.62, 0.30], [0.70, 0.26], [0.78, 0.26],      # right brow
    [0.25, 0.40], [0.31, 0.38], [0.35, 0.41],      # left eye (8 = pupil-ish)
    [0.65, 0.41], [0.69, 0.38], [0.75, 0.40],      # right eye
    [0.50, 0.45], [0.44, 0.55], [0.50, 0.58],      # nose bridge/tip
    [0.56, 0.55], [0.50, 0.62],                     # nostrils/base
    [0.35, 0.72], [0.42, 0.69], [0.50, 0.68],      # mouth top
    [0.58, 0.69], [0.65, 0.72], [0.50, 0.74],      # mouth corners/bottom
    [0.42, 0.76], [0.58, 0.76],                     # lower lip
    [0.38, 0.88], [0.62, 0.88],                     # chin
])
assert CANON27.shape == (27, 2)


def rand_affine(rng, lm, scale=(0.88, 1.15), rot_deg=15.0, trans=0.05):
    """Per-face pose/identity/bbox variation: random similarity transform
    of the landmark template about the patch center.  Real training data
    has exactly this spread (pose + identity + detector bbox noise); it is
    what makes JDA's joint alignment+classification meaningful — features
    become discriminative only as the shape estimate converges."""
    th = np.deg2rad(rng.uniform(-rot_deg, rot_deg))
    s = rng.uniform(*scale)
    R = s * np.array(
        [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]]
    )
    t = rng.uniform(-trans, trans, 2)
    return (lm - 0.5) @ R.T + 0.5 + t


def draw_face_structure(rng, img, lm, keep=None):
    """Landmark blobs + brightness bands shared by faces and near-face
    distractors (per-instance darkness/strength).

    Everything is SCALE-PROPORTIONAL (blob radius, band thickness ~ size):
    a detection window samples a larger face by truncated coordinate
    scaling (c/jda.c:375-381 semantics — subsampling, no averaging), so a
    face rendered at 2x must subsample to the same structure the model
    trained on; fixed-pixel blobs vanish under subsampling and killed
    round-3's first scene eval (PERF.md)."""
    size = img.shape[0]
    dark = int(rng.integers(10, 60))
    r = max(1, size // 24)  # blob radius ~ 1 at the 48px training scale
    if keep is None:
        keep = np.ones(len(lm), bool)
    for (gx, gy), kp in zip(lm, keep):
        if not kp:
            continue
        x, y = int(gx * size), int(gy * size)
        img[max(y - r, 0) : y + r + 1, max(x - r, 0) : x + r + 1] = dark
    # forehead band + cheek highlights, placed relative to the eyes/brows
    ys = int(np.clip(lm[:6, 1].min() * size, 2, size - 2))
    bh = max(3, size // 16)
    if rng.random() > 0.15:
        img[max(ys - size // 6, 0) : ys, size // 4 : 3 * size // 4] += int(
            rng.integers(25, 75)
        )
    if rng.random() > 0.4:
        cy = int(np.clip(lm[13, 1] * size, 3, size - bh - 1))
        ch = int(rng.integers(15, 50))
        img[cy : cy + bh, size // 8 : size // 4] += ch
        img[cy : cy + bh, 3 * size // 4 : 7 * size // 8] += ch


def band_limit(img_u8, stride=1.0):
    """Blur so content survives resampling at `stride` unchanged in
    distribution.  CRITICAL for synthetic data: positives are subsampled
    (truncated coord map, like the detection scan) while mined negatives
    are bilinear-resized (the device miner's taps) — with full-amplitude
    per-pixel noise those two treatments differ in texture statistics, and
    the cascade learns THAT instead of face structure.  Band-limited
    content is sampling-method agnostic, like real photographs.

    `cv2_gaussian_blur` is OpenCV's 8-bit GaussianBlur bit for bit, so
    this needs no OpenCV."""
    sigma = max(0.6, 0.6 * stride)
    return cv2_gaussian_blur(img_u8.astype(np.uint8), sigma)


def _render_face(rng, size, jitter=0.018, raw=False):
    """Face structure at native `size` (no window jitter).  raw=True
    skips the band-limit (for callers that blur after compositing)."""
    base = int(rng.integers(85, 175))
    spread = int(rng.integers(15, 45))
    img = rng.integers(base - spread, base + spread, (size, size)).astype(
        np.int32
    )
    lm = rand_affine(rng, CANON27) + rng.normal(0, jitter, CANON27.shape)
    lm = np.clip(lm, 0.04, 0.96)
    draw_face_structure(rng, img, lm)
    img += rng.integers(-12, 13, (size, size))
    img = np.clip(img, 0, 255).astype(np.uint8)
    if raw:
        return img, lm.reshape(-1)
    return band_limit(img, size / 48.0), lm.reshape(-1)


def subsample_window(canvas, x0, y0, w, out):
    """Sample an out*out patch from canvas window (x0, y0, w) by the
    detector's coordinate map: patch[y, x] = canvas[y0 + trunc(y*w/out),
    x0 + trunc(x*w/out)] (the C scan evaluates features on the original
    pixels at truncated scaled coords, c/jda.c:375-381 — windows are
    never actually resized)."""
    idx = (np.arange(out) * w) // out
    return canvas[np.asarray(y0 + idx)[:, None], np.asarray(x0 + idx)[None, :]]


def make_face(rng, size, jitter=0.018, windowed=True):
    """A positive, generated the way DETECTION will see it: render the
    face at a random larger scale R, surround it with clutter margin,
    then subsample a jittered window back to `size` through the same
    truncated coordinate map the scan ladder uses.

    The window jitter (scale 0.87-1.2, center ±6%) teaches the cascade
    the tolerance band the C-API ladder's quantization demands: a 1.25x
    scale ladder's best window sits at w/R in [1/sqrt(1.25), sqrt(1.25)]
    = [0.894, 1.118] and up to 0.05*win off-center (spatial step
    0.1*win) — the training band must COVER that range (round-4 finding:
    the earlier [0.95, 1.2] band missed [0.894, 0.95), and scene recall
    at the 1.25 ladder paid for it; without any window jitter at all,
    recall collapses to ~2%, round-3 PERF.md).  GT landmarks are mapped
    into window coords, so the joint regressor learns to snap from the
    mean-shape init to the true (jittered) position, exactly the
    reference's random-shift design (data.cpp:225-253)."""
    if not windowed:
        return _render_face(rng, size, jitter)
    R = int(rng.integers(size, 3 * size + 1))
    face, lm = _render_face(rng, R, jitter, raw=True)
    # clutter margin so jittered windows never read out of bounds
    m = (R // 3) + 2
    C = R + 2 * m
    canvas = rng.integers(40, 215, (C, C)).astype(np.uint8)
    canvas[m : m + R, m : m + R] = face
    canvas = band_limit(canvas, R / 48.0)  # face + margin in one pass
    lm = lm.reshape(-1, 2) * R + m
    # jittered window (in canvas coords)
    w = int(round(R * rng.uniform(0.87, 1.2)))
    cx = m + R / 2 + rng.uniform(-0.06, 0.06) * R
    cy = m + R / 2 + rng.uniform(-0.06, 0.06) * R
    x0 = int(np.clip(round(cx - w / 2), 0, C - w))
    y0 = int(np.clip(round(cy - w / 2), 0, C - w))
    patch = subsample_window(canvas, x0, y0, w, size)
    out_lm = (lm - (x0, y0)) / w
    return patch.astype(np.uint8), np.clip(out_lm, 0.0, 1.0).reshape(-1)


def make_bg(rng, size=220):
    """A background tile with a HARDNESS CONTINUUM of face-like clutter.

    Real background corpora contain everything from texture to almost-
    faces; hard-negative mining only stays supplied deep into the cascade
    if the synthetic pool has the same continuum.  Each tile embeds
    near-faces whose landmark jitter ranges from barely-distorted (0.03 —
    just outside the positives' 0.018) to scrambled (0.12), with randomly
    dropped landmarks, brightness shifts, and missing structure bands."""
    bg = rng.integers(50, 210, (size, size)).astype(np.int32)
    for _ in range(60):  # dark blobs + bright bands
        x, y = rng.integers(2, size - 4, 2)
        bg[y : y + 3, x : x + 3] = 25
    for _ in range(10):
        x = int(rng.integers(0, size - 40))
        y = int(rng.integers(0, size - 12))
        w = int(rng.integers(12, 40))
        bg[y : y + 5, x : x + w] += 55
    for _ in range(12):
        s = int(rng.integers(28, 80))
        if s + 2 >= size:
            continue
        x0, y0 = (int(v) for v in rng.integers(0, size - s - 1, 2))
        # distortion floor sits just above the positives' jitter (0.018),
        # and the jitter DISTRIBUTION concentrates at the floor
        # (exponential): most distractors are nearly on the positive
        # manifold, because only those survive a deep cascade — a uniform
        # spread starves stage-2+ mining at ~5e-5 false-positive rates
        jitter = float(min(0.022 + rng.exponential(0.015), 0.10))
        lm = rand_affine(rng, CANON27) + rng.normal(0, jitter, CANON27.shape)
        lm = np.clip(lm, 0.04, 0.96)
        # the hardest (lowest-jitter) distractors keep all landmarks —
        # they differ from positives ONLY in landmark placement
        drop_p = np.clip((jitter - 0.022) * 4.0, 0.0, 0.3)
        keep = rng.random(len(lm)) > drop_p
        patch = bg[y0 : y0 + s, x0 : x0 + s]
        base = int(rng.integers(85, 175))
        spread = int(rng.integers(15, 45))
        patch[:] = rng.integers(base - spread, base + spread, (s, s))
        draw_face_structure(rng, patch, lm, keep)
        patch += rng.integers(-12, 13, (s, s))
    # Edge-clipped TRUE faces (structure at positive-level jitter, but
    # with the face center outside the tile so no window inside the tile
    # can reach IoU >= 0.5 with the face box): unlimited deep-stage
    # hard-negative supply — "half a face" is exactly what the detector
    # must reject at off-by-one ladder positions, and unlike near-face
    # distractors these never run dry as the cascade sharpens (round-3
    # mining exhaustion, PERF.md).  Classic bg-corpus trick; the tile
    # stays a legitimate no-face background.
    for _ in range(4):
        s = int(rng.integers(40, 110))
        face, _lm = _render_face(rng, s)
        side = int(rng.integers(0, 4))
        cut = int(rng.integers(s // 2 + 2, s - 4))  # visible strip < half
        if side == 0:  # left edge: right part of face visible
            h = min(s, size)
            y0 = int(rng.integers(0, size - h + 1))
            bg[y0 : y0 + h, 0 : s - cut] = face[:h, cut:]
        elif side == 1:  # right edge: left part visible
            h = min(s, size)
            y0 = int(rng.integers(0, size - h + 1))
            bg[y0 : y0 + h, size - (s - cut) :] = face[:h, : s - cut]
        elif side == 2:  # top edge: bottom part visible
            w = min(s, size)
            x0 = int(rng.integers(0, size - w + 1))
            bg[0 : s - cut, x0 : x0 + w] = face[cut:, :w]
        else:  # bottom edge: top part visible
            w = min(s, size)
            x0 = int(rng.integers(0, size - w + 1))
            bg[size - (s - cut) :, x0 : x0 + w] = face[: s - cut, :w]
    # mining windows (w -> 48 bilinear) must see the same texture
    # statistics positives carry — see band_limit
    return band_limit(np.clip(bg, 0, 255).astype(np.uint8), 1.5)


def _window_face_iou(cx, cy, w, fx, fy, R):
    """IoU of a square window (center cx,cy, size w) with the face box
    (corner fx,fy, size R) — the same overlap the scene eval scores."""
    x0, y0 = cx - w / 2.0, cy - w / 2.0
    ix = max(0.0, min(x0 + w, fx + R) - max(x0, fx))
    iy = max(0.0, min(y0 + w, fy + R) - max(y0, fy))
    inter = ix * iy
    return inter / (w * w + R * R - inter)


def _lerp(a, b, d):
    return a + (b - a) * d


def _d2(v1, v2, d):
    """Extended-range value for difficulty d in [0, 2]: flat v1 through
    d <= 1, then v1 -> v2 over (1, 2].  Round 4 trained with the ladder
    pinned at 1.0 and still truncated stages 1-4 by 9-23 carts when the
    near-miss pool ran dry (VERDICT r4 weak #3); the (1, 2] band keeps
    hard-negative supply alive by pushing every knob toward the decision
    boundary: jitter floors just above the positive band, thinner
    occlusions, boundary-IoU windows pressed against the 0.48 line."""
    return _lerp(v1, v2, max(0.0, min(d, 2.0) - 1.0))


def make_near_miss(rng, size=48, difficulty=0.0, mode=None):
    """A pre-registered near-miss candidate for the hard-negative factory
    (NegGenerator.load_hard_factory).

    Round 3's mining starved at stage 2+ because scan windows almost never
    REGISTER with tile content inside the tolerance band the windowed
    positives teach — so the cascade rejects every scan window trivially
    and the supply dries up (FP -> 0 over 3.3M windows).  These candidates
    are built by the SAME windowed rendering as positives (identical
    nuisance statistics: band-limit, subsample map, clutter margin) but
    differ in exactly one labeled way, each a thing a detector must reject
    around a true face:

      mode 0  off-scale window (IoU < .5 via wrong window size)
      mode 1  off-center window (IoU < .5 via offset)
      mode 2  registered window, landmarks off-manifold (jitter above
              the positives' 0.018 band)
      mode 3  registered window, structural band occluded/erased
      mode 4  boundary-IoU window (combined slight off-scale+off-center
              landing at IoU just under the 0.5 acceptance line — the
              support vectors of detection; a cascade can never fully
              reject these without losing true positives, so this mode
              keeps mining supplied at ANY depth)

    `difficulty` in [0, 1] moves every mode from its easy range toward
    the hardest parameters that are still unambiguously negative (IoU
    <= 0.47, jitter >= ~1.5x the positive band).  generate_hard raises
    it whenever batch acceptance falls under 10%, so the candidate
    stream tracks the cascade's decision boundary instead of being
    rejected wholesale (round-3's exponential mining-cost blowup).

    Like the reference's hard pool (data.cpp:893-897), every candidate is
    still validated by the current cascade before becoming a negative."""
    dd_ = float(np.clip(difficulty, 0.0, 2.0))
    d = min(dd_, 1.0)
    mode = int(rng.integers(0, 5)) if mode is None else int(mode)
    R = int(rng.integers(size, 2 * size + 1))
    if mode == 2:
        jitter = float(
            rng.uniform(
                _d2(_lerp(0.045, 0.028, d), 0.023, dd_),
                _d2(_lerp(0.09, 0.045, d), 0.034, dd_),
            )
        )
    else:
        jitter = 0.018
    face, _lm = _render_face(rng, R, jitter, raw=True)
    if mode == 3:
        y0 = int(rng.uniform(0.15, 0.6) * R)
        hgt = int(
            rng.uniform(
                _d2(_lerp(0.20, 0.13, d), 0.09, dd_),
                _d2(_lerp(0.35, 0.22, d), 0.15, dd_),
            )
            * R
        )
        face[y0 : y0 + hgt] = int(rng.integers(40, 215))
    m = R  # margin wide enough for 2.5x off-scale windows
    Csz = 3 * R
    canvas = rng.integers(40, 215, (Csz, Csz)).astype(np.uint8)
    canvas[m : m + R, m : m + R] = face
    canvas = band_limit(canvas, R / 48.0)
    fcx = m + R / 2
    if mode == 0:
        if rng.random() < 0.5:
            ratio = rng.uniform(_lerp(1.50, 1.47, d), _lerp(2.5, 1.7, d))
        else:
            ratio = rng.uniform(_lerp(0.45, 0.58, d), _lerp(0.65, 0.68, d))
        w = int(round(R * ratio))
        cx = fcx + rng.uniform(-0.05, 0.05) * R
        cy = fcx + rng.uniform(-0.05, 0.05) * R
    elif mode == 1:
        w = int(round(R * rng.uniform(0.95, 1.2)))
        ang = rng.uniform(0, 2 * np.pi)
        dd = rng.uniform(_lerp(0.30, 0.27, d), _lerp(0.55, 0.36, d)) * R
        cx = fcx + np.cos(ang) * dd
        cy = fcx + np.sin(ang) * dd
    elif mode == 4:
        lo = _d2(_lerp(0.25, 0.38, d), 0.44, dd_)
        cx = cy = fcx + 0.6 * R  # fallback, overwritten below
        w = R
        for _ in range(60):
            ratio = rng.uniform(0.75, 1.4)
            w_ = R * ratio
            ang = rng.uniform(0, 2 * np.pi)
            dfrac = rng.uniform(0.0, 0.5)
            cx_ = fcx + np.cos(ang) * dfrac * R
            cy_ = fcx + np.sin(ang) * dfrac * R
            if lo <= _window_face_iou(cx_, cy_, w_, m, m, R) <= 0.47:
                w, cx, cy = int(round(w_)), cx_, cy_
                break
    else:
        w = int(round(R * rng.uniform(0.95, 1.2)))
        cx = fcx + rng.uniform(-0.05, 0.05) * R
        cy = fcx + rng.uniform(-0.05, 0.05) * R
    if mode in (0, 1, 4):
        # labeled-negative guarantee: never hand the trainer a window
        # that the scene eval would score as a true detection
        for _ in range(40):
            if _window_face_iou(cx, cy, w, m, m, R) < 0.48:
                break
            cx += (cx - fcx) * 0.2 + 0.05 * R
    x0 = int(np.clip(round(cx - w / 2), 0, Csz - w))
    y0 = int(np.clip(round(cy - w / 2), 0, Csz - w))
    return subsample_window(canvas, x0, y0, w, size).astype(np.uint8)


def make_hard_canvas(rng, size=48, difficulty=0.0):
    """A face canvas for the device-batched near-miss miner
    (jda_tpu_torch.train.mining.CanvasHardMiner): the face render + clutter
    margin + band-limit of make_face, WITHOUT choosing the window — the
    miner extracts many candidate windows per canvas on device, so the
    ~1.5 ms host render amortizes (a 1-core host renders ~1k candidates/s;
    per-patch rendering was the round-3/4 deep-stage mining wall).

    Returns (canvas u8 [C, C], (fx, fy, R), any_window):
      kind 0  TRUE face (jitter in the positive band) — only boundary-IoU
              windows are negatives (any_window=False; the miner samples
              IoU in [lo(difficulty), 0.48] — modes 0/1/4 of
              make_near_miss were all window geometry);
      kind 1  off-manifold landmarks (jitter above the positive band,
              narrowing toward it with difficulty) — any registered
              window is a negative;
      kind 2  structural band occluded/erased — any registered window is
              a negative.
    """
    dd_ = float(np.clip(difficulty, 0.0, 2.0))
    d = min(dd_, 1.0)
    # kind weights from the round-4 acceptance probe vs the stage-1
    # cascade (scripts/probe_neg_acceptance.py): geometry-misregistered
    # windows are rejected in ~3 carts (0% acceptance — the cascade nails
    # them early and forever), while near-manifold registered faces are
    # the only distribution that still supplies negatives deep into the
    # cascade (~1% at max difficulty).  Off-manifold kinds carry the pool.
    kind = int(rng.choice(3, p=[0.2, 0.5, 0.3]))
    R = int(rng.integers(size, 2 * size + 1))
    if kind == 1:
        jitter = float(
            rng.uniform(
                _d2(_lerp(0.05, 0.026, d), 0.022, dd_),
                _d2(_lerp(0.09, 0.04, d), 0.032, dd_),
            )
        )
    else:
        jitter = 0.018
    face, _lm = _render_face(rng, R, jitter, raw=True)
    if kind == 2:
        y0 = int(rng.uniform(0.15, 0.6) * R)
        hgt = int(
            rng.uniform(
                _d2(_lerp(0.20, 0.13, d), 0.09, dd_),
                _d2(_lerp(0.35, 0.22, d), 0.15, dd_),
            )
            * R
        )
        face[y0 : y0 + hgt] = int(rng.integers(40, 215))
    m = R  # margin wide enough for 1.6x off-scale windows at 0.75R offset
    Csz = 3 * R
    canvas = rng.integers(40, 215, (Csz, Csz)).astype(np.uint8)
    canvas[m : m + R, m : m + R] = face
    # difficulty > 1: with rising probability, plant a second, smaller,
    # OFF-MANIFOLD face in the margin — multi-face near-miss clutter (a
    # window registered on it is a labeled negative, a window on the main
    # face keeps its usual IoU constraint) that mining never saw at d<=1
    if dd_ > 1.0 and rng.random() < 0.5 * (dd_ - 1.0):
        R2 = max(24, int(R * rng.uniform(0.45, 0.7)))
        face2, _ = _render_face(rng, R2, jitter=0.05, raw=True)
        corner = int(rng.integers(0, 4))
        oy = 0 if corner < 2 else Csz - R2
        ox = 0 if corner % 2 == 0 else Csz - R2
        canvas[oy : oy + R2, ox : ox + R2] = face2
    canvas = band_limit(canvas, R / 48.0)
    return canvas, (m, m, R), kind != 0


def flagship_config():
    from jda_tpu_torch.config import Config

    # field-for-field from the reference's model/config.json (stages block)
    return Config(
        T=5,
        K=540,
        landmark_n=27,
        tree_depth=4,
        shift_size=0.02,
        multi_scale=False,
        img_o_size=48,
        img_h_size=36,
        img_q_size=24,
        mining_th=(0.2,) * 5,
        feats=(2000,) * 5,
        radius=(0.3, 0.2, 0.15, 0.12, 0.1),
        probs=(0.9, 0.8, 0.7, 0.6, 0.5),
        recall=(0.99,) * 5,
        drops=(1,) * 5,  # shipped uses 2 of 50k faces; 1 of ~16k keeps the
        # same order of positive attrition over 2700 carts
        nps=(1.0,) * 5,
        score_normalization_steps=(10,) * 5,
        restart_on=True,
        restart_th=(0.001,) * 5,
        restart_times=5,
        face_augment_on=False,
        left_pupils=(8,),
        right_pupils=(13,),
        snapshot_iter=10_000,
        seed=11,
    )


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-pos", type=int, default=16384)
    ap.add_argument("--n-bg", type=int, default=400)
    ap.add_argument(
        "--out", default=os.path.join("models", "flagship_torch"),
        help="output directory (models, partial models, stats, snapshots)",
    )
    ap.add_argument("--stages", type=int, default=5)
    ap.add_argument(
        "--k", type=int, default=540,
        help="carts per stage (smoke tests only; flagship is 540)",
    )
    ap.add_argument(
        "--drops", type=int, default=None,
        help="positives dropped per cart (default: 1 if n-pos >= 8192 else "
        "0 — the shipped config's 2-of-50k attrition scaled to corpus size; "
        "T*K drops must stay well under n-pos or training runs dry)",
    )
    ap.add_argument(
        "--resume",
        default=None,
        help="stage-end model snapshot to continue from (requires --resume-data)",
    )
    ap.add_argument(
        "--resume-data",
        default=None,
        help="corpus snapshot (DataSet.snapshot) matching --resume",
    )
    # mining-economics knobs for deep stages of a near-converged detector
    # (FP ~1e-5: multi-minute mining events net a handful of negatives)
    ap.add_argument(
        "--mining-th", type=float, default=None,
        help="override config mining_th (re-mine when neg pool falls below "
        "this fraction of the quota; lower = fewer mining events)",
    )
    ap.add_argument(
        "--dry-yield-frac", type=float, default=0.0,
        help="mining events netting < frac*want negatives count as dry; "
        "two consecutive dry events pass-through-finalize the stage "
        "(Trainer.dry_yield_frac)",
    )
    ap.add_argument(
        "--no-restart", action="store_true",
        help="disable cart restarts (tiny mined pools quantize drop rates "
        "to 0%% and trigger pathological restart loops)",
    )
    ap.add_argument(
        "--mining-max-batches", type=int, default=400,
        help="bound on validation dispatches per mining event",
    )
    ap.add_argument(
        "--device", default=None,
        help="torch device (default: the CUDA card; without one this raises)",
    )
    ap.add_argument(
        "--max-seconds", type=float, default=None,
        help="stop before the first cart that would start past this many "
        "seconds of training; the partial model and the stats are written",
    )
    return ap.parse_args(argv)


def build_trainer(args, device):
    """The trainer of `main`: the config from the flags, the corpus (fresh
    from seed 7, or the snapshot pair of --resume / --resume-data) and the
    three factories registered.  Returns (trainer, config)."""
    from jda_tpu_torch.data import DataSet, patch_row
    from jda_tpu_torch.params import load_model
    from jda_tpu_torch.train.boost import Trainer
    from jda_tpu_torch.utils import log

    c = flagship_config()
    drops = args.drops if args.drops is not None else (1 if args.n_pos >= 8192 else 0)
    if args.stages < 5 or args.k != 540 or drops != 1:
        c = dataclasses.replace(
            c, T=args.stages, K=args.k, drops=(drops,) * args.stages
        )
    if args.mining_th is not None:
        c = dataclasses.replace(c, mining_th=(args.mining_th,) * c.T)
    if args.no_restart:
        c = dataclasses.replace(c, restart_on=False)

    model = None
    if args.resume:
        if not args.resume_data:
            raise ValueError("--resume needs --resume-data")
        model = load_model(args.resume)
    tr = Trainer(c, model=model, device=device)
    # the miner stops as soon as the quota fills, so a high cap only costs
    # wall-clock when supply is genuinely thin (deep stages)
    tr.mining_max_batches = args.mining_max_batches
    tr.mining_batch = 8192
    tr.dry_yield_frac = args.dry_yield_frac
    rng = np.random.default_rng(7)
    if args.resume:
        # continue from a stage-end snapshot pair (model + corpus); the
        # port takes true sizes, so nothing is reserved
        log(f"resuming from {args.resume} + {args.resume_data}")
        DataSet.resume(args.resume_data, tr.pos, tr.neg)
        tr.neg_gen.load_factory(
            lambda i: make_bg(np.random.default_rng(7_000_000 + i)), rng
        )
    else:
        log(f"generating {args.n_pos} faces + {args.n_bg} backgrounds")
        rows, gts = [], []
        for _ in range(args.n_pos):
            f, lm = make_face(rng, c.img_o_size)
            rows.append(patch_row(f, c))
            gts.append(lm)
        # unbounded background supply: tile i is deterministic in i, so the
        # scan states can wrap a virtually-infinite list (the reference
        # scans tens of thousands of on-disk background images)
        tr.set_synthetic_data(
            np.stack(rows),
            np.stack(gts),
            [],
            neg_factory=lambda i: make_bg(np.random.default_rng(7_000_000 + i)),
        )
    # unlimited pre-registered near-miss supply for deep-stage mining;
    # the 2-arg signature opts into generate_hard's adaptive difficulty
    tr.neg_gen.load_hard_factory(
        lambda i, d=0.0: make_near_miss(
            np.random.default_rng(9_000_000 + i), c.img_o_size, d
        )
    )
    # device-batched canvas miner: preferred near-miss path (one render,
    # many windows); the per-patch factory above remains the fallback
    tr.neg_gen.load_canvas_factory(
        lambda i, d=0.0: make_hard_canvas(
            np.random.default_rng(9_500_000 + i), c.img_o_size, d
        )
    )
    return tr, c


class _OutOfTime(Exception):
    """Raised before a cart once --max-seconds has passed."""


def _mining_summary(ev):
    """One mining event of Trainer.stats, as JSON: its cart, want, yield and
    seconds, and for the scan and each top-up the windows (or candidates)
    screened, their rate, and the host's seconds in it (rebuild and
    revalidation; the canvas factory's and the hard factory's renders)."""

    def part(d, secs, host_keys):
        if d is None or secs is None:
            return None
        out = {
            "screened": int(d.get("screened", 0)),
            "mined": int(d["mined"]),
            "seconds": float(secs),
            "screened_per_s": float(d.get("screened", 0)) / max(float(secs), 1e-9),
            "host_s": sum(float(d.get(k, 0.0)) for k in host_keys),
            "fp_rate": float(d["fp_rate"]),
        }
        if "difficulty" in d:
            out["difficulty"] = float(d["difficulty"])
        return out

    # the scan's own seconds (the device miner's; the host scan keeps none)
    scan_s = ev["screen_s"] + ev["revalidate_s"] if "screen_s" in ev else None
    canvas, hard = ev["canvas"], ev["hard"]
    return {
        "stage": int(ev["stage"]),
        "cart": int(ev["cart"]),
        "want": int(ev["want"]),
        "mined": int(ev["mined"]),
        "seconds": float(ev["seconds"]),
        "max_batches": int(ev["max_batches"]),
        "scan": part(dict(ev, mined=ev["scan_mined"]), scan_s, ("revalidate_s",)),
        "canvas": part(canvas, canvas and canvas["seconds"], ("render_s", "revalidate_s")),
        "hard": part(hard, hard and hard["seconds"], ("render_s",)),
    }


def main(argv=None):
    args = parse_args(argv)
    from jda_tpu_torch.params import save_model
    from jda_tpu_torch.utils import calc_mean_error, log, resolve_device

    device = resolve_device(args.device)
    tr, c = build_trainer(args, device)
    e0 = calc_mean_error(
        tr.pos.gt_shapes[tr.pos.live],
        tr.pos.current_shapes[tr.pos.live],
        c.left_pupils,
        c.right_pupils,
    )
    log(f"mean error at start {e0:.4f}")
    pos_at_start = int(tr.pos.size)

    os.makedirs(args.out, exist_ok=True)
    # stage-end snapshots (model + full corpus, ~1 GB each) make every
    # stage boundary resumable
    tr.snapshot_dir = os.path.join(args.out, "snapshots")

    # per-cart timing: wrap train_cart; model-only checkpoint every 60
    # carts (full corpus snapshots are ~1 GB — model alone is ~5 MB).
    # allow_incomplete_stage: a save at cart K-1 precedes the stage's
    # global regression, and save_model refuses to mark such a stage
    # complete — the flag writes a resumable (t, K-2) cursor instead.
    cart_times = []
    orig = tr.train_cart
    mpath_tmp = os.path.join(args.out, "flagship_synth.partial.model")
    t_start = time.time()

    def timed(t, k):
        if args.max_seconds is not None and time.time() - t_start > args.max_seconds:
            raise _OutOfTime
        t0 = time.time()
        orig(t, k)
        cart_times.append(time.time() - t0)
        if (k + 1) % 60 == 0:
            save_model(
                tr.model, mpath_tmp, dtype="double",
                allow_incomplete_stage=True,
            )

    tr.train_cart = timed

    # keep a per-stage model artifact (stage's W verified by save_model's
    # complete-stage check) + stage wall-clock
    orig_stage = tr.train_stage
    stage_times = []

    def staged(t):
        t0 = time.time()
        orig_stage(t)
        stage_times.append(time.time() - t0)
        save_model(
            tr.model,
            os.path.join(args.out, f"flagship_synth.stage{t+1}.model"),
            dtype="double",
        )
        log(f"stage {t+1} wall-clock {stage_times[-1]/60:.1f} min")

    tr.train_stage = staged

    t0 = time.time()
    stopped = False
    try:
        tr.train()
    except _OutOfTime:
        stopped = True
    total = time.time() - t0

    pl = tr.pos.live_idx()
    e1 = calc_mean_error(
        tr.pos.gt_shapes[pl],
        tr.pos.current_shapes[pl],
        c.left_pupils,
        c.right_pupils,
    )
    if stopped:
        # the cursor of the last kept cart (a cart being restarted when the
        # time ran out is not trained)
        kept = [e for e in tr.stats["carts"] if e["stage"] == tr.model.stage_idx]
        tr.model.cart_idx = kept[-1]["cart"] if kept else -1
        mpath = mpath_tmp
        save_model(tr.model, mpath, dtype="double", allow_incomplete_stage=True)
        log(f"stopped after {total:.0f} s at stage {tr.model.stage_idx + 1}, cart "
            f"{tr.model.cart_idx + 1}: partial model -> {mpath}")
    else:
        mpath = os.path.join(args.out, "flagship_synth.model")
        tr.model.stage_idx, tr.model.cart_idx = c.T, -1
        save_model(tr.model, mpath, dtype="double")
    stats = {
        "n_pos": args.n_pos,
        "T": c.T,
        "K": c.K,
        "total_sec": total,
        "per_cart_sec_mean": float(np.mean(cart_times)) if cart_times else None,
        "per_cart_sec_p50": float(np.median(cart_times)) if cart_times else None,
        "per_stage_sec": [float(s) for s in stage_times],
        "mean_error_initial": float(e0),
        "mean_error_final": float(e1),
        "pos_survivors": int(tr.pos.size),
        "stages": tr.stats["stages"],
        # the port's additions: the device, where training stopped, and
        # each mining event
        "device": str(device),
        "stopped": stopped,
        "cursor": [int(tr.model.stage_idx), int(tr.model.cart_idx)],
        "carts_trained": len(cart_times),  # train_cart calls, restarts included
        "pos_at_start": pos_at_start,
        "mining": [_mining_summary(e) for e in tr.stats["mining"]],
    }
    with open(os.path.join(args.out, "flagship_synth.stats.json"), "w") as f:
        json.dump(stats, f, indent=1)
    log(json.dumps(stats))
    log(f"model -> {mpath}")
    return stats


if __name__ == "__main__":
    main()
