"""Logging and evaluation utilities (reference common.cpp)."""

from __future__ import annotations

import os
import time
from typing import Sequence, Tuple, Union

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


def dp_mesh(mesh) -> Tuple[object, int, int, torch.device]:
    """(process group, rank, world size, this rank's device) of a `mesh=`
    argument: a 1-D torch.distributed DeviceMesh whose dimension is "dp",
    one process per device.  Any other mesh raises.  On the card it selects
    this rank's device (LOCAL_RANK where a launcher set it, else the global
    rank modulo the cards), which NCCL's object collectives need."""
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= takes a torch.distributed DeviceMesh, not {type(mesh).__name__}"
        )
    if mesh.ndim != 1 or tuple(mesh.mesh_dim_names or ()) != ("dp",):
        raise ValueError(
            'mesh= takes a 1-D DeviceMesh whose dimension is "dp", not shape '
            f"{tuple(mesh.shape)} over {mesh.mesh_dim_names}"
        )
    group = mesh.get_group("dp")
    rank = torch.distributed.get_rank(group)
    nd = torch.distributed.get_world_size(group)
    if mesh.device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", torch.distributed.get_rank()))
        index = local % torch.cuda.device_count()
        torch.cuda.set_device(index)
        return group, rank, nd, torch.device("cuda", index)
    return group, rank, nd, torch.device(mesh.device_type)


def block(n: int, nd: int, rank: int) -> slice:
    """Rank `rank`'s contiguous rows of n rows split over nd ranks as a
    batch padded to a multiple of nd is: ceil(n / nd) rows per rank, pad
    rows dropped (the last ranks' ranges may be short or empty)."""
    per = -(-n // nd)
    r0 = min(rank * per, n)
    return slice(r0, min(r0 + per, n))


def same_device(a: torch.device, b: Union[str, torch.device]) -> bool:
    """Whether two devices name the same card (a CUDA device without an
    index is the current one)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (b.index if b.index is not None else cur)


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
