"""Multi-scale sliding-window detection (C API semantics).

PyTorch counterpart of the JAX package's detect.py.  Semantics follow the
reference C API `jdaDetect` (c/jda.c:318-480):

  * window sizes grow from 24 px by `scale`; slide step = int(0.1 * win)
    (the `step` argument is accepted and ignored, as in c/jda.c:333);
  * single-scale models read only the origin image, at coordinates
    truncated toward zero;
  * the shape starts at the mean shape; stage 0 runs densely over every
    window (ops/dense0.py), survivors run stages 1..T-1 with compaction
    (ops/fused.py);
  * final score threshold, greedy NMS (overlap 0.3), landmark relocation.

This slice covers single-scale models with T > 0 (the fused path).  Entry
points run on CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from jda_tpu_torch.params import CascadeParams
from jda_tpu_torch.ops import dense0 as D0
from jda_tpu_torch.ops import fused as F
from jda_tpu_torch.ops import nms as NMS


@dataclasses.dataclass
class DetectionResult:
    """Mirror of jdaResult (c/jda.h:18-24)."""

    n: int
    landmark_n: int
    bboxes: np.ndarray  # [n, 3] int32 (x, y, size)
    shapes: np.ndarray  # [n, 2L] float32, absolute image coords
    scores: np.ndarray  # [n] float32


def enumerate_windows(
    img_w: int,
    img_h: int,
    scale: float,
    min_size: int,
    max_size: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[Tuple[int, int, int, int]]]:
    """All candidate (x, y, win) in the reference's scan order
    (c/jda.c:331-339: win outer, y middle, x inner; step = int(win*0.1)).

    Also returns per-scale metadata [(win, step, ny, nx), ...] — the grid
    shape of each scan scale, consumed by the dense stage-0 filter.
    """
    xs: List[np.ndarray] = []
    ys: List[np.ndarray] = []
    ws: List[np.ndarray] = []
    scales: List[Tuple[int, int, int, int]] = []
    win = 24
    scale32 = np.float32(scale)
    while win < min_size:
        win = int(np.float32(win) * scale32)
    while win <= max_size:
        step = int(np.float32(win) * np.float32(0.1))
        step = max(step, 1)
        yy = np.arange(0, img_h - win + 1, step, dtype=np.int32)
        xx = np.arange(0, img_w - win + 1, step, dtype=np.int32)
        if len(yy) and len(xx):
            gy, gx = np.meshgrid(yy, xx, indexing="ij")
            xs.append(gx.reshape(-1))
            ys.append(gy.reshape(-1))
            ws.append(np.full(gx.size, win, np.int32))
            scales.append((win, step, len(yy), len(xx)))
        win = int(np.float32(win) * scale32)
    if not xs:
        z = np.zeros((0,), np.int32)
        return z, z, z, []
    return np.concatenate(xs), np.concatenate(ys), np.concatenate(ws), scales


def _empty(landmark_n: int) -> DetectionResult:
    return DetectionResult(
        0,
        landmark_n,
        np.zeros((0, 3), np.int32),
        np.zeros((0, 2 * landmark_n), np.float32),
        np.zeros((0,), np.float32),
    )


class Detector:
    """Detector over a loaded cascade (API of c/jda.h:62-63).

    Multi-scale models, T == 0 models, `mesh=` and the non-fused branch
    are not ported yet: they raise NotImplementedError naming the ROADMAP
    item that brings them.
    """

    def __init__(
        self,
        params: CascadeParams,
        final_th_default: float = 0.0,
        rounding: bool = False,
        device: Union[str, torch.device, None] = None,
    ):
        if device is None and not torch.cuda.is_available():
            raise RuntimeError(
                "jda_tpu_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run the plain PyTorch path"
            )
        self.device = torch.device("cuda" if device is None else device)
        self.rounding = bool(rounding)
        self.params = params
        self.dev = params.device_tensors(self.device, torch.float32)
        self.T = params.T
        self.K = params.K
        self.depth = params.tree_depth
        self.leaf_n = params.leaf_n
        self.final_th_default = final_th_default
        self.single_scale = bool((params.scale == 0).all())
        if self.T > 0:
            # host copies of stage-0 params for the dense filter's tables
            p32 = params.astype(np.float32)
            self._host_stage0 = {
                "lmk1": params.lmk1[0],
                "lmk2": params.lmk2[0],
                "off1": p32.off1[0],
                "off2": p32.off2[0],
                "feat_th": params.feat_th[0],
                "leaf_scores": p32.leaf_scores[0],
                "mean": p32.mean[0],
                "std": p32.std[0],
                "cart_th": p32.cart_th[0],
            }
            self._ms32 = params.mean_shape.astype(np.float32)
        self._plans: Dict[tuple, dict] = {}
        self._pinned: Optional[torch.Tensor] = None
        self._upload_done: Optional[torch.cuda.Event] = None
        self.last_stats: dict = {}

    def _check_fused(self) -> None:
        if not self.single_scale:
            raise NotImplementedError(
                "multi-scale models are not ported yet (ROADMAP A.9: the "
                "C++-semantics path with _scale_filter_ms)"
            )
        if self.T == 0:
            raise NotImplementedError(
                "models with T == 0 take the non-fused detect branch, which "
                "is not ported yet (ROADMAP A.7, left out)"
            )

    def _run_batch(self, *args, **kw):
        raise NotImplementedError(
            "Detector._run_batch (the non-fused stage loop) is not ported "
            "yet (ROADMAP A.7, left out)"
        )

    # -- plans ---------------------------------------------------------------

    def _plan(self, Hc, Wc, scale, min_size, max_size_c) -> dict:
        """Window ladder and per-scale dense tables for one canonical
        geometry (jdaDetect semantics, truncation), cached."""
        key = (Hc, Wc, float(scale), min_size, max_size_c, self.rounding)
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        x, y, win, scales = enumerate_windows(Wc, Hc, scale, min_size, max_size_c)
        tabs = []
        for w_, s_, _, _ in scales:
            t = D0.node_tables(
                self._ms32, self._host_stage0, w_, s_, rounding=self.rounding
            )
            tabi, tabf = D0.pack_tables(t, self.params.node_n)
            tabs.append(
                (
                    torch.as_tensor(tabi, device=self.device),
                    torch.as_tensor(tabf, device=self.device),
                )
            )
        plan = {
            "x": x,
            "y": y,
            "win": win,
            "n": len(x),
            "scales": tuple(scales),
            "tabs": tuple(tabs),
            "xywin": torch.as_tensor(
                np.stack([x, y, win], axis=1).astype(np.int32), device=self.device
            ),
            "Hc": Hc,
            "Wc": Wc,
        }
        self._plans[key] = plan
        return plan

    def _canonical(self, grays, min_size, max_size):
        Hc = max(g.shape[0] for g in grays)
        Wc = max(g.shape[1] for g in grays)
        min_size = max(min_size, 24)
        ms_c = max_size if max_size > 0 else min(Wc, Hc)
        ms_c = min(ms_c, Wc, Hc)
        return Hc, Wc, min_size, ms_c

    def _upload(self, grays, B, Hc, Wc) -> Tuple[torch.Tensor, torch.Tensor]:
        """Place the images top-left in canonical [B, Hc, Wc] planes on the
        device.  On CUDA the planes are staged in a reused pinned host
        buffer and copied with non_blocking=True."""
        dims = torch.zeros((B, 2), dtype=torch.int32)
        for i, g in enumerate(grays):
            dims[i, 0], dims[i, 1] = g.shape[1], g.shape[0]
        if self.device.type != "cuda":
            host = torch.zeros((B, Hc, Wc), dtype=torch.uint8)
        else:
            if self._pinned is None or tuple(self._pinned.shape) != (B, Hc, Wc):
                self._pinned = torch.empty((B, Hc, Wc), dtype=torch.uint8).pin_memory()
            elif self._upload_done is not None:
                self._upload_done.synchronize()  # previous copy has read it
            host = self._pinned
            host.zero_()
        for i, g in enumerate(grays):
            host[i, : g.shape[0], : g.shape[1]] = torch.from_numpy(g)
        imgs = host.to(self.device, non_blocking=True)
        if self.device.type == "cuda":
            self._upload_done = torch.cuda.Event()
            self._upload_done.record()
        return imgs, dims.to(self.device, non_blocking=True)

    def _run(self, plan, grays, B) -> Dict[str, torch.Tensor]:
        imgs, dims = self._upload(grays, B, plan["Hc"], plan["Wc"])
        return F.run_fused(
            self.dev,
            imgs,
            dims,
            plan["tabs"],
            plan["xywin"],
            meta=plan["scales"],
            depth=self.depth,
            leaf_n=self.leaf_n,
            T=self.T,
            H=plan["Hc"],
            W=plan["Wc"],
            rounding=self.rounding,
            s0_lbf=True,
        )

    # -- public API --------------------------------------------------------

    def detect(
        self,
        gray: np.ndarray,
        scale: float = 1.25,
        step: float = 0.1,
        min_size: int = 24,
        max_size: int = -1,
        th: Optional[float] = None,
        nms_overlap: float = 0.3,
    ) -> DetectionResult:
        """jdaDetect-compatible detection (c/jda.c:443-480) of one image."""
        if gray.dtype != np.uint8 or gray.ndim != 2:
            raise ValueError("detect: gray must be a 2-D uint8 image")
        return self.detect_batch(
            [gray], scale=scale, min_size=min_size, max_size=max_size, th=th,
            nms_overlap=nms_overlap,
        )[0]

    def detect_batch(
        self,
        grays: List[np.ndarray],
        scale: float = 1.25,
        min_size: int = 24,
        max_size: int = -1,
        th: Optional[float] = None,
        nms_overlap: float = 0.3,
        mesh=None,
    ) -> List[DetectionResult]:
        """jdaDetect over a batch of images in one fused pass.

        Images are placed top-left in canonical (max-dims) planes; windows
        are enumerated once on the canonical grid with per-image validity
        masks (ops/fused.py).  Per-image results equal single-image
        detection, since windows never read outside their own image.
        """
        if mesh is not None:
            raise NotImplementedError(
                "mesh= (multi-device detection) is not ported yet (ROADMAP "
                "A.7, left out: multi-GPU)"
            )
        self._check_fused()
        if th is None:
            th = self.final_th_default
        if not grays:
            return []
        Hc, Wc, min_size, ms_c = self._canonical(grays, min_size, max_size)
        plan = self._plan(Hc, Wc, scale, min_size, ms_c)
        if plan["n"] == 0:
            return [_empty(self.params.landmark_n) for _ in grays]
        out = self._run(plan, grays, len(grays))
        return self._harvest_batch(plan, out, len(grays), th, nms_overlap)

    def detect_stream(
        self,
        grays: List[np.ndarray],
        batch: int = 8,
        scale: float = 1.25,
        min_size: int = 24,
        max_size: int = -1,
        th: Optional[float] = None,
        nms_overlap: float = 0.3,
    ) -> List[DetectionResult]:
        """Throughput-mode detection over many images: chunks of `batch`
        images share one plan; each chunk is uploaded from pinned host
        memory.  Results identical to detect_batch."""
        self._check_fused()
        if th is None:
            th = self.final_th_default
        if not grays:
            return []
        Hc, Wc, min_size, ms_c = self._canonical(grays, min_size, max_size)
        plan = self._plan(Hc, Wc, scale, min_size, ms_c)
        if plan["n"] == 0:
            return [_empty(self.params.landmark_n) for _ in grays]
        results: List[DetectionResult] = []
        for i in range(0, len(grays), batch):
            chunk = grays[i : i + batch]
            out = self._run(plan, chunk, batch)
            results.extend(
                self._harvest_batch(plan, out, batch, th, nms_overlap)[: len(chunk)]
            )
        return results

    def _harvest_batch(self, plan, out, B, th, nms_overlap):
        """Host post-pass of one fused-batch output: per-image selection,
        NMS, window-frame -> image-frame shapes."""
        sel = out["sel"].cpu().numpy()
        score = out["score"].cpu().numpy()
        shape = out["shape"].cpu().numpy()
        alive = out["alive"].cpu().numpy()
        self.last_stats = {
            "windows": int(plan["n"]) * B,
            "counts": out["counts"].tolist(),
            "total_nvis": int(out["total_nvis"]),
        }

        n = plan["n"]
        x, y, win = plan["x"], plan["y"], plan["win"]
        keep = alive & (score >= th)
        bi = sel // n
        wi = sel % n
        results = []
        for i in range(B):
            m = keep & (bi == i)
            cand = wi[m]
            bboxes = np.stack([x[cand], y[cand], win[cand]], axis=1).astype(
                np.int32
            )
            cscores = score[m]
            cshapes = shape[m]
            picked = NMS.nms_c(bboxes, cscores, nms_overlap)
            bboxes = bboxes[picked]
            cscores = cscores[picked]
            cshapes = cshapes[picked]
            sz = bboxes[:, 2:3].astype(np.float32)
            outs = cshapes.copy()
            outs[:, 0::2] = outs[:, 0::2] * sz + bboxes[:, 0:1]
            outs[:, 1::2] = outs[:, 1::2] * sz + bboxes[:, 1:2]
            results.append(
                DetectionResult(
                    len(picked),
                    self.params.landmark_n,
                    bboxes,
                    outs,
                    cscores,
                )
            )
        return results


def detect(
    params: CascadeParams,
    gray: np.ndarray,
    device: Union[str, torch.device, None] = None,
    **kw,
) -> DetectionResult:
    """One-shot functional API."""
    return Detector(params, device=device).detect(gray, **kw)
