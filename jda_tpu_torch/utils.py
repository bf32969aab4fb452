"""Logging, timers, and evaluation utilities (reference common.cpp)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Sequence, Union

import numpy as np
import torch


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without CUDA the default raises; nothing falls back to the
    CPU on its own."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "jda_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return torch.device("cuda" if device is None else device)


def require_cv2(why: str):
    """OpenCV, or an ImportError that says what needed it.  Only reading,
    writing and drawing image files need OpenCV: every resize is
    ops/resize.cv2_resize."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"{why}; OpenCV (cv2) is not installed") from e
    return cv2


def log(msg: str) -> None:
    """Timestamped stdout log (LOG, common.cpp:17-28)."""
    stamp = time.strftime("%Y-%m-%d %H:%M:%S")
    print(f"[{stamp}] {msg}", flush=True)


@contextmanager
def timer(label: str):
    """Scoped wall-clock timer (TIMER_BEGIN/END, common.hpp:24-50)."""
    t0 = time.perf_counter()
    yield
    log(f"{label}: {time.perf_counter() - t0:.4f} s")


def calc_mean_error(
    gt_shapes: np.ndarray,  # [N, 2L]
    current_shapes: np.ndarray,  # [N, 2L]
    left_pupils: Sequence[int],
    right_pupils: Sequence[int],
) -> float:
    """Mean landmark error normalized by inter-pupil distance
    (calcMeanError, common.cpp:41-77): pupil position = mean of the
    configured landmark ids; per-sample error = mean over landmarks of
    euclidean distance / pupil distance; averaged over samples."""
    gx = gt_shapes[:, 0::2]
    gy = gt_shapes[:, 1::2]
    cx = current_shapes[:, 0::2]
    cy = current_shapes[:, 1::2]
    lp = np.asarray(left_pupils)
    rp = np.asarray(right_pupils)
    lpx = gx[:, lp].mean(1)
    lpy = gy[:, lp].mean(1)
    rpx = gx[:, rp].mean(1)
    rpy = gy[:, rp].mean(1)
    pupil_d = np.sqrt((lpx - rpx) ** 2 + (lpy - rpy) ** 2)
    dist = np.sqrt((gx - cx) ** 2 + (gy - cy) ** 2).mean(1)
    return float((dist / np.maximum(pupil_d, 1e-12)).mean())


def draw_density_graph(
    pos_scores: np.ndarray, neg_scores: np.ndarray, bins: int = 64
) -> str:
    """ASCII score-density plot of pos vs neg (draw_density_graph,
    btcart.cpp:19-102): one row per distribution, density by character."""
    lo = min(pos_scores.min(), neg_scores.min())
    hi = max(pos_scores.max(), neg_scores.max())
    if hi <= lo:
        hi = lo + 1.0
    chars = " .:-=+*#%@"
    rows = []
    for name, s in (("pos", pos_scores), ("neg", neg_scores)):
        h, _ = np.histogram(s, bins=bins, range=(lo, hi))
        d = h / max(h.max(), 1)
        rows.append(
            name + " |" + "".join(chars[int(v * (len(chars) - 1))] for v in d) + "|"
        )
    return "\n".join(rows) + f"\n     [{lo:.3f}, {hi:.3f}]"
