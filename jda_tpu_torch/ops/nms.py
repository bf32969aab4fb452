"""Non-maximum suppression of the C library (c/jda.c:237-316).

The survivor set after the cascade is tiny (tens of boxes), so NMS runs on
the host in numpy.  Its output order is part of the API contract with the
reference: boxes are squares (x, y, size); score-descending greedy
suppression with IoU > overlap (strict); the output keeps the original
candidate order (the final move loop iterates i = 0..n-1 over the input
order, c/jda.c:295-301).
"""

from __future__ import annotations

import numpy as np


def nms_c(bboxes: np.ndarray, scores: np.ndarray, overlap: float = 0.3) -> np.ndarray:
    """Greedy square-box NMS; returns indices of kept boxes in input order."""
    n = len(scores)
    if n == 0:
        return np.zeros((0,), np.int64)
    order = np.argsort(-scores, kind="stable")
    flag = np.ones(n, bool)
    x = bboxes[:, 0].astype(np.int64)
    y = bboxes[:, 1].astype(np.int64)
    sz = bboxes[:, 2].astype(np.int64)
    area = sz * sz
    for i in range(n - 1):
        k1 = order[i]
        if not flag[k1]:
            continue
        rest = order[i + 1 :]
        rest = rest[flag[rest]]
        if rest.size == 0:
            continue
        x1 = np.maximum(x[k1], x[rest])
        y1 = np.maximum(y[k1], y[rest])
        x2 = np.minimum(x[k1] + sz[k1], x[rest] + sz[rest])
        y2 = np.minimum(y[k1] + sz[k1], y[rest] + sz[rest])
        w = np.maximum(0, x2 - x1)
        h = np.maximum(0, y2 - y1)
        inter = (w * h).astype(np.float32)
        ov = inter / (area[k1] + area[rest] - w * h).astype(np.float32)
        flag[rest[ov > overlap]] = False
    return np.flatnonzero(flag)
