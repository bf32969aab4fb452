"""Non-maximum suppression, reproducing both reference variants.

The survivor set after the cascade is tiny (tens of boxes), so NMS runs on
the host in numpy.  Its output order is part of the API contract with the
reference, so both variants match it exactly:

  * `nms_c`: the C library's greedy NMS (c/jda.c:237-316).  Boxes are
    squares (x, y, size); score-descending greedy suppression with
    IoU > overlap (strict); the output keeps the original candidate order
    (the final move loop iterates i = 0..n-1 over the input order,
    c/jda.c:295-301).
  * `nms_cpp`: the C++ multimap variant (src/jda/cascador.cpp:387-429) used
    by `jda test` / `jda fddb`; rectangles may be non-square; the output is
    in pick order (score descending), and the suppression loop also erases
    the current maximum itself.
"""

from __future__ import annotations

import numpy as np

from jda_tpu_torch import tracing


def nms_c(bboxes: np.ndarray, scores: np.ndarray, overlap: float = 0.3) -> np.ndarray:
    """Greedy square-box NMS; returns indices of kept boxes in input order."""
    with tracing.span("nms"):
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


def nms_cpp(rects: np.ndarray, scores: np.ndarray, overlap: float = 0.3) -> np.ndarray:
    """C++ multimap NMS; rects [n,4] = (x, y, w, h); returns picked indices
    in score-descending pick order (cascador.cpp:387-429)."""
    n = len(scores)
    if n == 0:
        return np.zeros((0,), np.int64)
    x = rects[:, 0].astype(np.float64)
    y = rects[:, 1].astype(np.float64)
    w = rects[:, 2].astype(np.float64)
    h = rects[:, 3].astype(np.float64)
    areas = w * h
    # std::multimap orders by key ascending; equal scores keep insertion
    # order, and map.rbegin() picks the *last* inserted among maxima.  Each
    # pick removes the boxes it overlaps, one vectorised float64 pass over
    # the rest in their order (the reference's per-box loop, same values)
    order = np.argsort(scores, kind="stable")
    picked = []
    while order.size:
        last = order[-1]
        picked.append(last)
        x1 = np.maximum(x[order], x[last])
        y1 = np.maximum(y[order], y[last])
        x2 = np.minimum(x[order] + w[order], x[last] + w[last])
        y2 = np.minimum(y[order] + h[order], y[last] + h[last])
        ww = np.maximum(0.0, x2 - x1)
        hh = np.maximum(0.0, y2 - y1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ov = ww * hh / (areas[order] + areas[last] - ww * hh)
        order = order[ov <= overlap]
    return np.asarray(picked, np.int64)
