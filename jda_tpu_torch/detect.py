"""Multi-scale sliding-window detection (C API semantics).

PyTorch counterpart of the JAX package's detect.py.  Semantics follow the
reference C API `jdaDetect` (c/jda.c:318-480):

  * window sizes grow from 24 px by `scale`; slide step = int(0.1 * win)
    (the `step` argument is accepted and ignored, as in c/jda.c:333);
  * single-scale models read only the origin image, at coordinates
    truncated toward zero;
  * multi-scale models also read the half and quarter levels of the
    o/h/q pyramid (ops/pyramid.py: built on the detector's device, one
    launch an image on a card) through borrowed-memory patches
    (window_geometry);
  * the shape starts at the mean shape; for single-scale models stage 0
    runs densely over every window (ops/dense0.py);
  * final score threshold, greedy NMS (overlap 0.3), landmark relocation.

Two paths.  The fused path (ops/fused.py) serves single-scale models with
T > 0, a batch of images per call.  The non-fused path serves one image
per call: multi-scale models, T == 0 models, and any model when the
environment variable JDA_TPU_FUSED is "0".  On a CUDA device a multi-scale
model with T > 0 walks every window of the image's ladder through the
survivor tail kernel's multi-scale instantiation (ops/tail.py), one launch
an image; on the CPU, and for T == 0 models, `_run_batch` runs the plain
tail.  The C++-semantics detector (cascador.py) drives both paths through
explicit window ladders (`Detector._plan_windows`) and `_run_batch`.
Entry points run on CUDA unless the caller passes device="cpu".
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from jda_tpu_torch import tracing
from jda_tpu_torch.params import CascadeParams
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import dense0 as D0
from jda_tpu_torch.ops import fused as F
from jda_tpu_torch.ops import nms as NMS
from jda_tpu_torch.ops import pyramid as PY
from jda_tpu_torch.ops import resize as R
from jda_tpu_torch.ops import tail as TK
from jda_tpu_torch.utils import block, dp_mesh, resolve_device, same_device


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


def window_geometry(
    x: np.ndarray,
    y: np.ndarray,
    win: np.ndarray,
    offsets: np.ndarray,
    strides: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Per-window flat base/stride/patch dims for the three pyramid levels.

    Matches the borrowed-memory patches of c/jda.c:340-354: level o at
    (x, y); level h at (int(x*r), int(y*r)) with r = 1/sqrt(2) in float32;
    level q at (x/2, y/2); all three claim width = height = win.
    """
    n = x.shape[0]
    r = np.float32(1.0) / np.float32(math.sqrt(2.0))
    hx = (x.astype(np.float32) * r).astype(np.int32)
    hy = (y.astype(np.float32) * r).astype(np.int32)
    qx = x // 2
    qy = y // 2
    base = np.stack(
        [
            offsets[0] + y.astype(np.int64) * strides[0] + x,
            offsets[1] + hy.astype(np.int64) * strides[1] + hx,
            offsets[2] + qy.astype(np.int64) * strides[2] + qx,
        ],
        axis=1,
    ).astype(np.int32)
    stride = np.broadcast_to(strides[None, :], (n, 3)).astype(np.int32)
    pw = np.broadcast_to(win[:, None], (n, 3)).astype(np.int32)
    return {"base": base, "stride": stride, "pw": pw, "ph": pw.copy()}


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

    The fused path runs a whole batch in one pass (ops/fused.py).  The
    non-fused path takes one image per call.  Single-scale models: the
    dense stage-0 filter over the whole ladder (one `dense0_image` call),
    then every survivor through all stages at once (cascade_full).
    Multi-scale models with T > 0 on a CUDA device: every window of the
    ladder through the tail kernel's level walk (`_walk_levels`, one
    launch), stage 0's chain from cart 0, equal to `_run_batch` window
    for window.  Other models, and every model on the CPU, per geometry
    batch (`_run_batch`):
      1. *prefilter*: a dense result where the caller has one, or else the
         first `prefilter_carts` carts of stage 0 on every window in
         slabs; survivors are compacted.  This recovers the reference's
         early-exit economics (cascador.cpp:188-191) at batch granularity.
      2. per stage: every cart in chunks, the score chain and the exact
         regression, compacting survivors between stages.
    Re-running carts [0, prefilter) on survivors is exact: tree descent
    depends only on the (unchanged within a stage) shape, and the score
    chain recomputes the identical float sequence from zero.  For the same
    reason the kernel's walk, which runs stage 0 once from cart 0 and
    stops each window at its first reject, gives every window the score,
    alive, nvis and shape that `_run_batch` gives it.

    `detect_batch(mesh=)` splits a batch over the ranks of a 1-D
    torch.distributed DeviceMesh ("dp", one process per device): each rank
    runs its part on its own card and every rank returns the whole list.
    """

    SLAB = 1 << 16  # windows per prefilter pass (bounds temp memory)
    CART_CHUNK = 180  # carts per pass (bounds [N, C] temp memory)

    def __init__(
        self,
        params: CascadeParams,
        final_th_default: float = 0.0,
        prefilter_carts: int = 64,
        rounding: bool = False,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        # rounding=False reproduces the C API's coordinate truncation
        # (c/jda.c:375-381); rounding=True uses the C++ training semantics
        # (data.cpp:48-51)
        self.rounding = bool(rounding)
        self.params = params
        self.dev = params.device_tensors(self.device, torch.float32)
        self.T = params.T
        self.K = params.K
        self.depth = params.tree_depth
        self.leaf_n = params.leaf_n
        self.final_th_default = final_th_default
        self.single_scale = bool((params.scale == 0).all())
        self.prefilter_carts = min(prefilter_carts, self.K)
        self.pre_chunk = (
            {
                k: v[0, : self.prefilter_carts]
                for k, v in self.dev.items()
                if k not in ("W", "mean_shape")
            }
            if self.T > 0
            else None
        )
        # per-stage cart chunks, pre-sliced on the device
        self.stage_chunks = []
        for t in range(self.T):
            sp = C.stage_params(self.dev, t)
            self.stage_chunks.append(
                [
                    {k: v[c0 : c0 + self.CART_CHUNK] for k, v in sp.items()}
                    for c0 in range(0, self.K, self.CART_CHUNK)
                ]
            )
        if self.T > 0:
            # host copies of stage-0 params for the dense filter's tables
            p32 = params.astype(np.float32)
            self._host_stage0 = {
                "scale": params.scale[0],
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
        self._tab_cache: Dict[tuple, Dict[str, np.ndarray]] = {}
        self._plans: Dict[tuple, dict] = {}
        self._tail: Optional[TK.TailTables] = None
        self._pinned: Optional[torch.Tensor] = None
        self._upload_done: Optional[torch.cuda.Event] = None
        self.last_stats: dict = {}

    def _fused_enabled(self) -> bool:
        """The fused path serves single-scale models with T > 0 unless
        JDA_TPU_FUSED=0 (read at every call)."""
        return (
            self.single_scale
            and self.T > 0
            and os.environ.get("JDA_TPU_FUSED", "1") != "0"
        )

    # -- plans ---------------------------------------------------------------

    def _plan(self, Hc, Wc, scale, min_size, max_size_c) -> dict:
        """Window ladder and per-scale dense tables for one canonical
        geometry (jdaDetect semantics, truncation), cached."""
        key = ("c", Hc, Wc, float(scale), min_size, max_size_c, self.rounding)
        with tracing.span("plan"):
            plan = self._plans.get(key)
            if plan is None:
                x, y, win, scales = enumerate_windows(Wc, Hc, scale, min_size, max_size_c)
                plan = self._plan_windows(
                    key, Hc, Wc, x, y, win, scales, rounding=self.rounding
                )
        return plan

    def _plan_windows(
        self, key, Hc, Wc, x, y, win, scales, rounding: bool, origins=None
    ) -> dict:
        """Build and cache a plan from an explicit window ladder: the C-API
        ladder, the C++ path's method-1 ladder, and its banded method-0
        canvases, where `origins` gives each scan grid a canvas origin
        (y0, x0) and its node tables are shifted there (ops/fused.py).
        Dense tables are built for single-scale models with a stage 0;
        host node tables are cached per (win, step, rounding)."""
        tracing.count("plan.builds", 1)
        tabs = []
        for i, (w_, s_, _, _) in enumerate(
            scales if self.single_scale and self.T > 0 else ()
        ):
            tkey = (w_, s_, rounding)
            if tkey not in self._tab_cache:
                self._tab_cache[tkey] = D0.node_tables(
                    self._ms32, self._host_stage0, w_, s_, rounding=rounding
                )
            t = self._tab_cache[tkey]
            if origins is not None and tuple(origins[i]) != (0, 0):
                t = D0.shift_tables(t, origins[i][0], origins[i][1], s_)
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
            "scales": tuple(tuple(int(v) for v in m) for m in scales),
            "tabs": tuple(tabs),
            "xywin": torch.as_tensor(
                np.stack([x, y, win], axis=1).astype(np.int32).reshape(-1, 3),
                device=self.device,
            ),
            "rounding": bool(rounding),
            "origins": None if origins is None else tuple(tuple(o) for o in origins),
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
        with tracing.span("upload"):
            dims = torch.zeros((B, 2), dtype=torch.int32)
            for i, g in enumerate(grays):
                dims[i, 0], dims[i, 1] = g.shape[1], g.shape[0]
            if self.device.type != "cuda":
                host = torch.zeros((B, Hc, Wc), dtype=torch.uint8)
            else:
                host = self._staging((B, Hc, Wc))
                host.zero_()
            for i, g in enumerate(grays):
                host[i, : g.shape[0], : g.shape[1]] = torch.from_numpy(g)
            imgs = host.to(self.device, non_blocking=True)
            self._staged()
            return imgs, dims.to(self.device, non_blocking=True)

    def _staging(self, shape) -> torch.Tensor:
        """The reused pinned host buffer of `shape` (made anew for another
        shape), once the previous copy from it has read it."""
        if self._pinned is None or tuple(self._pinned.shape) != tuple(shape):
            self._pinned = torch.empty(shape, dtype=torch.uint8).pin_memory()
        elif self._upload_done is not None:
            with tracing.span("upload.wait"):
                self._upload_done.synchronize()  # previous copy has read it
        return self._pinned

    def _staged(self) -> None:
        """Mark the copy just enqueued from the pinned buffer (CUDA only)."""
        if self.device.type == "cuda":
            self._upload_done = torch.cuda.Event()
            self._upload_done.record()

    def _dense_tables(self, plan: dict) -> Optional[D0.ImageTables]:
        """The kernels' tables of a plan (ops/dense0.prepare_image), checked
        and built at the plan's first use and kept with it: the fused and
        the non-fused path take the same set.  None on the CPU, where the
        plain filter reads the per-scale tables alone."""
        if self.device.type != "cuda":
            return None
        if "image" not in plan:
            plan["image"] = D0.prepare_image(
                plan["tabs"], meta=plan["scales"], depth=self.depth,
                H=plan["Hc"], W=plan["Wc"],
            )
        return plan["image"]

    def _tail_tables(self) -> Optional[TK.TailTables]:
        """The survivor tail kernel's tables (ops/tail.pack_tables), built at
        the first call of a CUDA detector that runs the kernel and kept.
        None on the CPU, where the plain tail reads the model's tensors
        alone."""
        if self.device.type != "cuda":
            return None
        if self._tail is None:
            self._tail = TK.pack_tables(self.dev, self.depth)
        return self._tail

    def _run(self, plan, grays, B, dims=None) -> Dict[str, torch.Tensor]:
        """One fused pass of a plan over a batch: `grays` placed top-left in
        its [B, Hc, Wc] planes; `dims`, where given, replaces each image's
        own (w, h) ([B, S, 2] per band for banded plans)."""
        imgs, img_dims = self._upload(grays, B, plan["Hc"], plan["Wc"])
        if dims is not None:
            img_dims = torch.as_tensor(np.asarray(dims, np.int32), device=self.device)
        return F.run_fused(
            self.dev,
            imgs,
            img_dims,
            plan["tabs"],
            plan["xywin"],
            meta=plan["scales"],
            depth=self.depth,
            leaf_n=self.leaf_n,
            T=self.T,
            H=plan["Hc"],
            W=plan["Wc"],
            rounding=plan["rounding"],
            s0_lbf=True,
            prepared=self._dense_tables(plan),
            origins=plan["origins"],
            tail=self._tail_tables(),
        )

    # -- non-fused path: one image, host ladder, compaction between stages ---

    def _dense_filter(self, img: torch.Tensor, plan: dict):
        """Full stage-0 rejection over all scan scales of one [H, W] uint8
        image (ops/dense0.py): on CUDA one `dense0_image` call, with the
        kernel's tables kept in the plan.  Returns (score, alive, nvis) on
        the device, flat in window enumeration order."""
        return D0.stage0_filter_image(
            img, plan["tabs"], meta=plan["scales"], depth=self.depth,
            prepared=self._dense_tables(plan),
        )

    def _walk_levels(
        self, flat_dev: torch.Tensor, plan: dict, offsets: np.ndarray, strides: np.ndarray
    ) -> Dict[str, torch.Tensor]:
        """Every window of a plan through the tail kernel's multi-scale walk
        in one launch (ops/tail.walk with `levels`): `flat_dev` is the
        image's stacked pyramid on the device, `offsets` and `strides` its
        levels'.  Each window's o/h/q patch bases (window_geometry's
        `base`) go to the device at the plan's first walk and stay with it:
        they follow from the image size, which keys the plan.  Returns per
        window, on the device and in enumeration order, `score`, `alive`,
        `nvis` and `shape`, as `_run_batch` gives them."""
        if "levels" not in plan:
            base = window_geometry(plan["x"], plan["y"], plan["win"], offsets, strides)["base"]
            plan["levels"] = (torch.as_tensor(base, device=self.device),
                              tuple(int(s) for s in strides))
        out, _ = TK.walk(
            self._tail_tables(), flat_dev[None], plan["xywin"], None, None, None, None,
            None, rounding=self.rounding, split=0, levels=plan["levels"],
        )
        return out

    def _run_batch(
        self,
        flat_img: torch.Tensor,
        geom: Dict[str, np.ndarray],
        valid_n: int,
        rounding: bool = False,
        dense_result=None,
        with_stp: bool = False,
    ) -> Dict[str, np.ndarray]:
        """Run all stages on one geometry batch, compacting between stages.

        `flat_img` is the stacked pyramid on the detector's device; `geom`
        is window_geometry's host dict; `dense_result` an optional (score,
        alive, nvis) of the dense filter, as arrays or tensors.  State
        stays on the device between stages.  Returns host arrays: score
        [n], alive [n], shape [n, 2L], nvis [n], in the original window
        order.  Rejected windows keep the score, shape and nvis they died
        with; windows that the dense filter or the prefilter rejected
        have the mean shape.  `with_stp` applies the per-stage similarity
        transform of the C++ path (cascador.cpp:180): recomputed from the
        stage-entry shapes and shared by every cart chunk of the stage and
        by its regression.
        """
        dev = self.device
        n_total = geom["base"].shape[0]
        L2 = self.params.landmark_dim
        ms = self.dev["mean_shape"]

        # results in original order
        out = {
            "score": torch.full((n_total,), -float("inf"), dtype=torch.float32, device=dev),
            "alive": torch.zeros(n_total, dtype=torch.bool, device=dev),
            "shape": torch.zeros((n_total, L2), dtype=torch.float32, device=dev),
            "nvis": torch.zeros(n_total, dtype=torch.int32, device=dev),
        }

        def host():
            return {k: v.cpu().numpy() for k, v in out.items()}

        if valid_n == 0:
            return host()
        g = {
            k: torch.as_tensor(geom[k][:valid_n], device=dev)
            for k in ("base", "stride", "pw", "ph")
        }
        # live index set (into original window order)
        live_idx = torch.arange(valid_n, device=dev)

        # phase 1: reject the bulk of windows cheaply.  Preferred: the dense
        # full-stage-0 filter; else the gather prefilter over the first
        # prefilter_carts carts.
        if dense_result is not None:
            score_d, alive_d, nvis_d = (
                (a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a)))
                .to(dev)[:valid_n]
                for a in dense_result
            )
            out["score"][:valid_n] = score_d
            out["nvis"][:valid_n] = nvis_d
            out["shape"][:valid_n] = ms
            live_idx = live_idx[alive_d]
        elif self.pre_chunk is not None and self.prefilter_carts < self.K:
            keep_parts = []
            for s0 in range(0, valid_n, self.SLAB):
                s1 = min(s0 + self.SLAB, valid_n)
                state = C.init_state(
                    s1 - s0, ms, g["base"][s0:s1], g["stride"][s0:s1],
                    g["pw"][s0:s1], g["ph"][s0:s1],
                    torch.ones(s1 - s0, dtype=torch.bool, device=dev),
                )
                state, _ = C.run_cart_chunk(
                    self.pre_chunk, flat_img, state, depth=self.depth,
                    rounding=rounding, single_scale=self.single_scale,
                )
                out["score"][s0:s1] = state["score"]
                out["nvis"][s0:s1] = state["nvis"]
                out["shape"][s0:s1] = ms
                keep_parts.append(state["alive"])
            live_idx = live_idx[torch.cat(keep_parts)]

        carried = None  # survivors' shape, score and nvis between stages
        for t in range(self.T):
            m = live_idx.shape[0]
            if m == 0:
                break
            state = C.init_state(
                m, ms, g["base"][live_idx], g["stride"][live_idx],
                g["pw"][live_idx], g["ph"][live_idx],
                torch.ones(m, dtype=torch.bool, device=dev),
            )
            if carried is not None:
                state.update(carried)
            stp = C.st_calc_dev(state["shape"], ms) if with_stp else None
            leaves_parts = []
            for chunk in self.stage_chunks[t]:
                state, lv = C.run_cart_chunk(
                    chunk, flat_img, state, depth=self.depth, rounding=rounding,
                    single_scale=self.single_scale, stp=stp,
                )
                leaves_parts.append(lv)
            state = C.apply_regression(
                self.dev["W"][t], torch.cat(leaves_parts, dim=1), state,
                leaf_n=self.leaf_n, stp=stp,
            )
            # record rejected lanes' final values; keep survivors live
            keep = state["alive"]
            for k in out:
                out[k][live_idx] = state[k]
            live_idx = live_idx[keep]
            carried = {k: state[k][keep] for k in ("shape", "score", "nvis")}
        return host()

    def _pyramid(self, gray: np.ndarray, plan: dict):
        """A multi-scale model's o/h/q levels of one image on the detector's
        device (ops/pyramid.py): the image alone goes into the head of a
        buffer of exactly the plan's pyramid length, and h and q are built
        behind it there (on CUDA one `pyramid_levels` launch, the image
        staged in the reused pinned buffer and copied with
        non_blocking=True).  Returns (flat, offsets, strides), as
        `stack_pyramid(pyramid_c(gray))` gives them."""
        H, W = gray.shape
        if "pyramid" not in plan:
            plan["pyramid"] = PY.layout(H, W)
        lay = plan["pyramid"]
        src = torch.from_numpy(np.ascontiguousarray(gray))
        if self.device.type == "cuda":
            src = self._staging((H, W)).copy_(src)
        flat = torch.empty(lay.F, dtype=torch.uint8, device=self.device)
        flat[: H * W].view(H, W).copy_(src, non_blocking=True)
        self._staged()
        PY.fill_levels(flat, lay)
        return flat, lay.offsets, lay.strides

    def _detect_unfused(
        self, gray, scale, min_size, max_size, th, nms_overlap, batch
    ) -> DetectionResult:
        """One image through its pyramid and ladder: the dense filter plus
        cascade_full on the survivors (single-scale models), the tail
        kernel's level walk (multi-scale models with T > 0 on a CUDA
        device), or _run_batch (the rest)."""
        img_h, img_w = gray.shape
        min_size = max(min_size, 24)
        if max_size <= 0:
            max_size = min(img_w, img_h)
        max_size = min(max_size, img_w, img_h)
        plan = self._plan(img_h, img_w, scale, min_size, max_size)
        x, y, win, n = plan["x"], plan["y"], plan["win"], plan["n"]
        L2 = self.params.landmark_dim
        if n == 0:
            return _empty(self.params.landmark_n)
        with tracing.span("pyramid"):
            if self.single_scale:
                # single-scale models never read the half/quarter levels
                flat, offsets, strides = R.stack_pyramid(
                    (gray, np.zeros((1, 1), np.uint8), np.zeros((1, 1), np.uint8)))
                flat_dev = torch.from_numpy(flat).to(self.device)
            else:
                flat_dev, offsets, strides = self._pyramid(gray, plan)

        if self.single_scale and self.T > 0:
            # stage-0 dead windows are done; every survivor runs the full
            # cascade from the mean shape (cascade_full), a slab at a time.
            # Only survivors can be accepted, so only they come back.
            _, alive_d, _ = self._dense_filter(
                flat_dev[: img_h * img_w].view(img_h, img_w), plan
            )
            idx = torch.nonzero(alive_d).reshape(-1).cpu().numpy()
            if len(idx) == 0:
                return _empty(self.params.landmark_n)
            geom = window_geometry(x[idx], y[idx], win[idx], offsets, strides)
            parts = []
            for s0 in range(0, len(idx), self.SLAB):
                m = min(self.SLAB, len(idx) - s0)
                state = C.init_state(
                    m,
                    self.dev["mean_shape"],
                    *(
                        torch.as_tensor(geom[k][s0 : s0 + m], device=self.device)
                        for k in ("base", "stride", "pw", "ph")
                    ),
                    torch.ones(m, dtype=torch.bool, device=self.device),
                )
                parts.append(C.cascade_full(
                    self.dev, flat_dev, state, depth=self.depth,
                    rounding=self.rounding, leaf_n=self.leaf_n, T=self.T,
                    exact=True, single_scale=True,
                ))
            scores, alive, shapes = (
                torch.cat([p[k] for p in parts]).cpu().numpy()
                for k in ("score", "alive", "shape")
            )
            keep = alive & (scores >= th)  # final threshold (c/jda.c:413-414)
            cand, cscores, cshapes = idx[keep], scores[keep], shapes[keep]
        elif self.T > 0 and self.device.type == "cuda":
            # multi-scale: the whole ladder in one launch; only every
            # window's score and alive come back, and the shapes of those
            # the final threshold keeps
            out = self._walk_levels(flat_dev, plan, offsets, strides)
            scores = out["score"].cpu().numpy()
            alive = out["alive"].cpu().numpy()
            cand = np.nonzero(alive & (scores >= th))[0]
            cscores = scores[cand]
            cshapes = out["shape"][torch.as_tensor(cand, device=self.device)].cpu().numpy()
        else:
            idx = np.arange(n)
            scores = np.zeros(n, np.float32)
            alive = np.zeros(n, bool)
            shapes = np.zeros((n, L2), np.float32)
            for s0 in range(0, n, batch):
                s1 = min(s0 + batch, n)
                geom = window_geometry(x[s0:s1], y[s0:s1], win[s0:s1], offsets, strides)
                tracing.count("run_batch.calls", 1)
                tracing.count("run_batch.windows", s1 - s0)
                with tracing.span("run_batch"):
                    res = self._run_batch(flat_dev, geom, s1 - s0, rounding=self.rounding)
                scores[s0:s1] = res["score"]
                alive[s0:s1] = res["alive"]
                shapes[s0:s1] = res["shape"]
            keep = alive & (scores >= th)
            cand, cscores, cshapes = idx[keep], scores[keep], shapes[keep]

        bboxes = np.stack([x[cand], y[cand], win[cand]], axis=1).astype(np.int32)
        picked = NMS.nms_c(bboxes, cscores, nms_overlap)
        bboxes = bboxes[picked]
        cscores = cscores[picked]
        out = cshapes[picked]

        # landmark relocation (c/jda.c:465-474)
        sz = bboxes[:, 2:3].astype(np.float32)
        out[:, 0::2] = out[:, 0::2] * sz + bboxes[:, 0:1].astype(np.float32)
        out[:, 1::2] = out[:, 1::2] * sz + bboxes[:, 1:2].astype(np.float32)
        return DetectionResult(len(picked), self.params.landmark_n, bboxes, out, cscores)

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
        batch: int = 1 << 20,
    ) -> DetectionResult:
        """jdaDetect-compatible detection (c/jda.c:443-480) of one image.
        `batch` bounds the windows per geometry batch of the non-fused
        path's `_run_batch`."""
        with tracing.call("detect", 1):
            if gray.dtype != np.uint8 or gray.ndim != 2:
                raise ValueError("detect: gray must be a 2-D uint8 image")
            if th is None:
                th = self.final_th_default
            if self._fused_enabled():
                return self.detect_batch(
                    [gray], scale=scale, min_size=min_size, max_size=max_size, th=th,
                    nms_overlap=nms_overlap,
                )[0]
            return self._detect_unfused(
                gray, scale, min_size, max_size, th, nms_overlap, batch
            )

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
        Models the fused path does not serve (multi-scale, T == 0, or
        JDA_TPU_FUSED=0) fall back to per-image detection.

        `mesh` (a 1-D DeviceMesh over "dp"; every rank calls with the same
        images, its detector on its rank's device) splits the batch into
        contiguous parts of ceil(B / ranks) images, each rank runs its part
        through the plan of the whole batch's canonical size, and one
        all_gather_object hands every rank all results in input order.  The
        per-image fallback ignores `mesh`, as the JAX package does.
        """
        with tracing.call("detect_batch", len(grays)):
            part, group, nd = slice(None), None, 1
            if mesh is not None:
                group, rank, nd, device = dp_mesh(mesh)
                if not same_device(device, self.device):
                    raise ValueError(
                        f"the detector's device {self.device} is not this rank's "
                        f"mesh device {device}"
                    )
                part = block(len(grays), nd, rank)
            if th is None:
                th = self.final_th_default
            if not self._fused_enabled():
                return [
                    self.detect(
                        g, scale=scale, min_size=min_size, max_size=max_size, th=th,
                        nms_overlap=nms_overlap,
                    )
                    for g in grays
                ]
            if not grays:
                return []
            Hc, Wc, min_size, ms_c = self._canonical(grays, min_size, max_size)
            plan = self._plan(Hc, Wc, scale, min_size, ms_c)
            if plan["n"] == 0:
                return [_empty(self.params.landmark_n) for _ in grays]
            mine = grays[part]
            results = []
            if mine:
                out = self._run(plan, mine, len(mine))
                results = self._harvest_batch(plan, out, len(mine), th, nms_overlap)
            if group is None:
                return results
            parts = [None] * nd
            torch.distributed.all_gather_object(parts, results, group=group)
            return [r for p in parts for r in p]

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
        memory.  Results identical to detect_batch, which also serves the
        models the fused path does not."""
        with tracing.call("detect_stream", len(grays)):
            if th is None:
                th = self.final_th_default
            if not self._fused_enabled() or not grays:
                return self.detect_batch(
                    grays, scale=scale, min_size=min_size, max_size=max_size, th=th,
                    nms_overlap=nms_overlap,
                )
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
        with tracing.span("harvest"):
            with tracing.span("harvest.wait"):
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
