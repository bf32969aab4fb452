"""C++-path detection: JoinCascador::Detect with both fddb methods.

PyTorch counterpart of the JAX package's cascador.py.  The reference ships
two multi-scale scanners (selected by fddb.method, src/jda/cascador.cpp:
431-443):

  * method 0 (detectMultiScale, cascador.cpp:216-308): shrink-image
    pyramid with a fixed window of img_o_size; every window is resized to
    the o/h/q patch triple with cv::resize before validation;
  * method 1 (detectMultiScale1, cascador.cpp:310-376): fixed full-res
    o/h/q images (h = 1/sqrt(2), q = 1/2), growing window from
    fddb_minimum_size, zero-copy ROI patches with true per-scale dims.

Both use C++ semantics: std::round feature coordinates, mean-shape init
(shift_size forced to 0 by the fddb/test commands, src/test.cpp:17,75),
multimap NMS in score order.

Mapping onto the port.  Single-scale models run stage 0 through the dense
filter's kernels with rounding tables: `dense0_image` for one image of
method 1, `dense0_filter` inside the fused pass (ops/fused.py) for a batch
of method-1 images and for method 0, whose pyramid levels are packed as
bands of one canvas per image.  Multi-scale models run method 0 through
the plain multi-scale dense filter (ops/dense0.stage0_filter_all_scales_ms)
and method 1 through `Detector._run_batch`.  Every `cv::resize` of the
reference is `ops/resize.cv2_resize`, the port's bit-exact model of
OpenCV's, so no OpenCV is needed and the CPU and the card take one path.
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
from jda_tpu_torch.config import Config
from jda_tpu_torch.detect import Detector
from jda_tpu_torch.params import CascadeParams
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import dense0 as D0
from jda_tpu_torch.ops import nms as NMS
from jda_tpu_torch.ops import resize as R

Result = Tuple[np.ndarray, np.ndarray, np.ndarray, "DetectionStatistic"]


@dataclasses.dataclass
class DetectionStatistic:
    """DetectionStatisic (cascador.hpp:14-25)."""

    patch_n: int = 0
    face_patch_n: int = 0
    nonface_patch_n: int = 0
    cart_gothrough_n: int = 0

    @property
    def average_cart_n(self) -> float:
        return self.cart_gothrough_n / max(self.nonface_patch_n, 1)

    def add(self, other: "DetectionStatistic") -> None:
        self.patch_n += other.patch_n
        self.face_patch_n += other.face_patch_n
        self.nonface_patch_n += other.nonface_patch_n
        self.cart_gothrough_n += other.cart_gothrough_n


def corpus_geometry(n: int, dims: Tuple[int, int, int]) -> Dict[str, np.ndarray]:
    """Per-sample scale geometry for patches stored as [N, D] flat rows
    (the JAX package's train/features.corpus_geometry).

    D = sum(d*d); sample i's scale-s patch starts at i*D + offset[s] in the
    flattened [N*D] buffer, so the rows are addressable by the same (base,
    stride, pw, ph) scheme as detection windows.
    """
    D = sum(d * d for d in dims)
    offs = np.cumsum([0] + [d * d for d in dims[:-1]])
    base = (np.arange(n, dtype=np.int64)[:, None] * D + offs[None, :]).astype(
        np.int32
    )
    dims_a = np.asarray(dims, np.int32)
    stride = np.broadcast_to(dims_a, (n, 3)).copy()
    return {
        "base": base,
        "stride": stride,
        "pw": stride.copy(),
        "ph": stride.copy(),
    }


def _empty(L2: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    return np.zeros((0, 4), np.int32), np.zeros(0), np.zeros((0, L2))


def _nms_relocate(c: Config, rects, scores, shapes):
    """The final block of Detect (cascador.cpp:448-474): multimap NMS, then
    window-relative shapes to image coordinates."""
    with tracing.span("nms"):
        if c.fddb_nms:
            picked = NMS.nms_cpp(rects, scores, c.fddb_overlap)
        else:
            picked = np.arange(len(rects))
        rects = rects[picked]
        scores = scores[picked]
        shapes = shapes[picked].copy()
        shapes[:, 0::2] = rects[:, 0:1] + shapes[:, 0::2] * rects[:, 2:3]
        shapes[:, 1::2] = rects[:, 1:2] + shapes[:, 1::2] * rects[:, 3:4]
        return rects, scores, shapes


class CppDetector:
    """`jda test` / `jda fddb` detection pipeline.  `device` as for
    `Detector`: CUDA unless "cpu" is given; without CUDA the default
    raises."""

    def __init__(
        self,
        params: CascadeParams,
        config: Config,
        device: Union[str, torch.device, None] = None,
    ):
        self.params = params
        self.c = config
        self.det = Detector(params, rounding=True, device=device)
        self.device = self.det.device
        self._tab_cache: Dict[tuple, Dict[str, np.ndarray]] = {}
        self._taps_ok: Optional[bool] = None

    # -- method 1: ROI windows over a fixed o/h/q pyramid -------------------

    def _enumerate_m1(self, W: int, H: int):
        c = self.c
        xs, ys, ws, scales = [], [], [], []
        win = c.fddb_minimum_size
        step = c.fddb_step
        while win <= W and win <= H:
            yy = np.arange(0, H - win + 1, step, dtype=np.int32)
            xx = np.arange(0, W - win + 1, step, dtype=np.int32)
            if len(yy) and len(xx):
                gy, gx = np.meshgrid(yy, xx, indexing="ij")
                xs.append(gx.reshape(-1))
                ys.append(gy.reshape(-1))
                ws.append(np.full(gx.size, win, np.int32))
                scales.append((win, step, len(yy), len(xx)))
            win = int(win * c.fddb_scale_factor)
        if not xs:
            z = np.zeros(0, np.int32)
            return z, z, z, []
        return np.concatenate(xs), np.concatenate(ys), np.concatenate(ws), scales

    def _m1_plan(self, H: int, W: int) -> dict:
        """The method-1 ladder of an [H, W] plane with rounding tables, as a
        detector plan (cached): per image for `_detect_m1`, per canonical
        plane for `_detect_batch_m1`."""
        c = self.c
        key = ("fddb1", H, W, c.fddb_minimum_size, c.fddb_step,
               float(c.fddb_scale_factor))
        with tracing.span("plan"):
            plan = self.det._plans.get(key)
            if plan is None:
                x, y, win, scales = self._enumerate_m1(W, H)
                plan = self.det._plan_windows(
                    key, H, W, x, y, win, scales, rounding=True
                )
        return plan

    def _geometry_m1(self, x, y, win, offsets, strides):
        """True per-scale ROI dims (cascador.cpp:335-343): h at
        (int(x/r), int(y/r)) size int(win/r); q at (x/2, y/2) size win/2."""
        r = math.sqrt(2.0)
        hx = (x / r).astype(np.int32)
        hy = (y / r).astype(np.int32)
        base = np.stack(
            [
                offsets[0] + y.astype(np.int64) * strides[0] + x,
                offsets[1] + hy.astype(np.int64) * strides[1] + hx,
                offsets[2] + (y // 2).astype(np.int64) * strides[2] + x // 2,
            ],
            axis=1,
        ).astype(np.int32)
        n = len(x)
        stride = np.broadcast_to(strides[None, :], (n, 3)).astype(np.int32).copy()
        pw = np.stack(
            [win, (win / r).astype(np.int32), win // 2], axis=1
        ).astype(np.int32)
        return {"base": base, "stride": stride, "pw": pw, "ph": pw.copy()}

    def _detect_m1(self, gray: np.ndarray, stat: DetectionStatistic):
        H, W = gray.shape
        r = math.sqrt(2.0)
        img_h = R.cv2_resize(gray, int(W / r), int(H / r))
        img_q = R.cv2_resize(gray, W // 2, H // 2)
        flat, offsets, strides = R.stack_pyramid((gray, img_h, img_q))
        flat_dev = torch.from_numpy(flat).to(self.device)

        plan = self._m1_plan(H, W)
        x, y, win, n = plan["x"], plan["y"], plan["win"], plan["n"]
        if n == 0:
            return _empty(self.params.landmark_dim)
        geom = self._geometry_m1(x, y, win, offsets, strides)
        # dense stage 0 with rounding tables: valid because single-scale
        # models read only the origin image, where method-1 windows have
        # pw = ph = win and the full image's stride
        dense = (
            self.det._dense_filter(flat_dev[: H * W].view(H, W), plan)
            if self.det.single_scale and self.det.T > 0
            else None
        )
        res = self.det._run_batch(
            flat_dev,
            geom,
            n,
            rounding=True,
            dense_result=dense,
            with_stp=self.c.with_similarity_transform,
        )
        alive = res["alive"]
        stat.patch_n += n
        stat.face_patch_n += int(alive.sum())
        stat.nonface_patch_n += int((~alive).sum())
        stat.cart_gothrough_n += int(res["nvis"][~alive].sum())
        keep = np.flatnonzero(alive)
        rects = np.stack([x[keep], y[keep], win[keep], win[keep]], 1).astype(
            np.int32
        )
        return (
            rects,
            res["score"][keep].astype(np.float64),
            res["shape"][keep].astype(np.float64),
        )

    # -- method 0: shrink pyramid + per-window patch resize ------------------

    def _validate_patches(self, rows: np.ndarray):
        """Batched JoinCascador::Validate on [m, D] uint8 o/h/q patch rows
        (shift 0).  Returns host (alive, score, shape, nvis)."""
        c = self.c
        dev = self.device
        m = len(rows)
        geom = corpus_geometry(m, (c.img_o_size, c.img_h_size, c.img_q_size))
        state = C.init_state(
            m,
            self.det.dev["mean_shape"],
            *(torch.as_tensor(geom[k], device=dev) for k in ("base", "stride", "pw", "ph")),
            torch.ones(m, dtype=torch.bool, device=dev),
        )
        out = C.cascade_full(
            self.det.dev,
            torch.from_numpy(np.ascontiguousarray(rows).reshape(-1)).to(dev),
            state,
            depth=self.params.tree_depth,
            rounding=True,
            leaf_n=self.params.leaf_n,
            T=self.params.T,
            exact=True,
            single_scale=self.det.single_scale,
            with_stp=c.with_similarity_transform,
        )
        return tuple(out[k].cpu().numpy() for k in ("alive", "score", "shape", "nvis"))

    def _patch_rows(self, img: np.ndarray, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        """The o/h/q patch rows of the win x win windows at (x, y) of one
        pyramid level: each window resized to the three patch sizes
        (cascador.cpp:243-245), flattened and concatenated, [m, D] uint8."""
        c = self.c
        win = c.img_o_size
        off = np.arange(win)
        rois = img[(y[:, None] + off)[:, :, None], (x[:, None] + off)[:, None, :]]
        return np.concatenate(
            [
                R.cv2_resize(rois, d, d).reshape(len(x), -1)
                for d in (c.img_o_size, c.img_h_size, c.img_q_size)
            ],
            axis=1,
        )

    def _pyramid_m0(self, gray: np.ndarray) -> List[Tuple[np.ndarray, float]]:
        """The reference shrink chain (cascador.cpp:285-304): level l+1 is
        a cv::resize of level l by 1/fddb_scale_factor.  Returns
        [(level_img, back_scale)]."""
        c = self.c
        win = c.img_o_size
        levels: List[Tuple[np.ndarray, float]] = []
        img, scale = gray, 1.0
        while img.shape[0] >= win and img.shape[1] >= win:
            levels.append((img, scale))
            scale *= c.fddb_scale_factor
            nw = int(img.shape[1] / c.fddb_scale_factor)
            nh = int(img.shape[0] / c.fddb_scale_factor)
            if nw < 1 or nh < 1:
                break
            img = R.cv2_resize(img, nw, nh)
        return levels

    def _m0_layout(self, Hc: int, Wc: int) -> List[Tuple[int, int, int]]:
        """Canonical packed-pyramid layout for a (Hc, Wc) canvas: bands
        (y0, h, w) stacked vertically, y0 aligned to fddb_step so the
        dense filter's shifted node tables stay phase-exact
        (ops/dense0.shift_tables)."""
        c = self.c
        win = c.img_o_size
        step = c.fddb_step
        bands: List[Tuple[int, int, int]] = []
        h, w, y0 = Hc, Wc, 0
        while h >= win and w >= win:
            bands.append((y0, h, w))
            y0 = -(-(y0 + h) // step) * step
            nw = int(w / c.fddb_scale_factor)
            nh = int(h / c.fddb_scale_factor)
            if nw < 1 or nh < 1:
                break
            h, w = nh, nw
        return bands

    def _m0_plan(self, Hc: int, Wc: int) -> dict:
        """Fused plan for the packed method-0 pyramid of an (Hc, Wc) image:
        one ladder entry per band, window grids offset to each band's
        origin, node tables shifted there."""
        c = self.c
        key = ("fddb0", Hc, Wc, c.img_o_size, c.fddb_step, float(c.fddb_scale_factor))
        plan = self.det._plans.get(key)
        if plan is not None:
            return plan
        layout = self._m0_layout(Hc, Wc)
        win, step = c.img_o_size, c.fddb_step
        xs, ys, ws, scales, origins = [], [], [], [], []
        for y0, h, w in layout:
            ny = (h - win) // step + 1
            nx = (w - win) // step + 1
            gy, gx = np.meshgrid(
                y0 + np.arange(ny, dtype=np.int32) * step,
                np.arange(nx, dtype=np.int32) * step,
                indexing="ij",
            )
            xs.append(gx.reshape(-1))
            ys.append(gy.reshape(-1))
            ws.append(np.full(gx.size, win, np.int32))
            scales.append((win, step, ny, nx))
            origins.append((int(y0), 0))
        if not layout:
            x = y = wn = np.zeros(0, np.int32)
        else:
            x = np.concatenate(xs)
            y = np.concatenate(ys)
            wn = np.concatenate(ws)
        Hp = (layout[-1][0] + layout[-1][1]) if layout else Hc
        plan = self.det._plan_windows(
            key, Hp, Wc, x, y, wn, scales, rounding=True, origins=origins
        )
        plan["m0_layout"] = layout
        plan["m0_band"] = (
            np.concatenate(
                [np.full(ny * nx, i, np.int32) for i, (_, _, ny, nx) in enumerate(scales)]
            )
            if scales
            else np.zeros(0, np.int32)
        )
        return plan

    def _m0_fast_applicable(self) -> bool:
        return self.det.single_scale and self.det._fused_enabled()

    def _detect_m0_raw_batch(self, grays, canon=None) -> List[Result]:
        """Packed-pyramid method 0 over an image batch: every level of every
        image rides one fused pass (the per-window cv::resize of
        cascador.cpp:243-245 degenerates to a direct crop for single-scale
        models: the scan window is img_o_size, and h/q patches are never
        read).  Returns per image (rects, scores, shapes_rel, stat): before
        NMS, shapes window-relative, exactly `_detect_m0_host`'s raw
        contract."""
        c = self.c
        det = self.det
        B = len(grays)
        win, step = c.img_o_size, c.fddb_step
        Hc = max(g.shape[0] for g in grays)
        Wc = max(g.shape[1] for g in grays)
        if canon is not None:
            Hc, Wc = max(Hc, canon[0]), max(Wc, canon[1])
        plan = self._m0_plan(Hc, Wc)
        layout = plan["m0_layout"]
        nb = len(layout)
        L2 = self.params.landmark_dim
        TK = self.params.T * self.params.K
        if plan["n"] == 0 or nb == 0:
            return [_empty(L2) + (DetectionStatistic(),) for _ in grays]

        imgs = np.zeros((B, plan["Hc"], Wc), np.uint8)
        dims = np.zeros((B, nb, 2), np.int32)
        backs = np.ones((B, nb), np.float64)
        for i, g in enumerate(grays):
            for li, (img, sc) in enumerate(self._pyramid_m0(g)):
                y0 = layout[li][0]
                imgs[i, y0 : y0 + img.shape[0], : img.shape[1]] = img
                dims[i, li] = (img.shape[1], img.shape[0])
                backs[i, li] = sc
        out = det._run(plan, imgs, B, dims=dims)
        sel = out["sel"].cpu().numpy()
        score = out["score"].cpu().numpy()
        shape = out["shape"].cpu().numpy()
        alive = out["alive"].cpu().numpy()
        # exact per-image visit banks of the fused pass (the reference's
        # per-image stat, test.cpp:146-149)
        nvis_img = out["nvis_img"].cpu().numpy()

        n = plan["n"]
        x, y = plan["x"], plan["y"]
        band = plan["m0_band"]
        y0s = np.asarray([b[0] for b in layout], np.int32)
        bi = sel // n
        wi = sel % n

        results = []
        for i in range(B):
            d = dims[i]
            mask_n = int(
                np.sum(
                    np.where(
                        (d >= win).all(axis=1),
                        ((d[:, 1] - win) // step + 1) * ((d[:, 0] - win) // step + 1),
                        0,
                    )
                )
            )
            m = alive & (bi == i)
            cand = wi[m]
            bnd = band[cand]
            back = backs[i, bnd]
            rx = (x[cand] * back).astype(np.int32)
            ry = ((y[cand] - y0s[bnd]) * back).astype(np.int32)
            rs = (win * back).astype(np.int32)
            stat = DetectionStatistic(
                patch_n=mask_n,
                face_patch_n=len(cand),
                nonface_patch_n=mask_n - len(cand),
                cart_gothrough_n=int(nvis_img[i]) - len(cand) * TK,
            )
            results.append(
                (
                    np.stack([rx, ry, rs, rs], 1).astype(np.int32),
                    score[m].astype(np.float64),
                    shape[m].astype(np.float64),
                    stat,
                )
            )
        return results

    def _detect_m0(self, gray: np.ndarray, stat: DetectionStatistic):
        if self._m0_fast_applicable():
            rects, scores, shapes, st = self._detect_m0_raw_batch([gray])[0]
            stat.add(st)
            return rects, scores, shapes
        if self._m0_dense_ms_applicable():
            return self._detect_m0_dense_ms(gray, stat)
        return self._detect_m0_host(gray, stat)

    def _m0_dense_ms_applicable(self) -> bool:
        """Multi-scale models with a stage 0 take the dense method-0 path
        unless JDA_TPU_M0_DENSE_MS=0 (read at every call)."""
        return (
            not self.det.single_scale
            and self.params.T > 0
            and os.environ.get("JDA_TPU_M0_DENSE_MS", "1") != "0"
            and self._cv_resize_model_ok()
        )

    def _cv_resize_model_ok(self) -> bool:
        """Whether the dense multi-scale tables and the survivors' patches
        read the same pixels.  The tables take their taps from
        `cv_linear_taps_fixed` (the JAX package's model of cv::resize, which
        its node_tables_ms uses); the patches come from `cv2_resize`.  On
        the (win -> o/h/q) shapes of the configuration the two give the
        same taps, and then `_detect_m0_dense_ms` is bit-exact against
        `_detect_m0_host`; where they differ, the host path serves.  The
        check compares the taps themselves, so it depends on no installed
        OpenCV (the JAX package checks its model against cv2 instead)."""
        if self._taps_ok is None:
            c = self.c
            win = c.img_o_size
            self._taps_ok = all(
                all(
                    np.array_equal(a, b)
                    for a, b in zip(
                        R.cv_linear_taps_fixed(win, d), R.cv2_taps(win, d, along_x)
                    )
                )
                for d in (c.img_o_size, c.img_h_size, c.img_q_size)
                for along_x in (True, False)
            )
        return self._taps_ok

    def _detect_m0_dense_ms(self, gray: np.ndarray, stat: DetectionStatistic):
        """Method-0 detection for multi-scale models through the dense
        stage-0 filter: each h/q feature pixel of a resized window patch is
        a fixed 4-tap OpenCV-exact combination of scan-level pixels
        (ops/dense0.node_tables_ms), so stage 0 runs densely over the
        packed pyramid; only stage-0 survivors pay the per-window resize
        and the full-cascade tail (cascador.cpp:216-262 semantics,
        bit-exact against `_detect_m0_host`)."""
        c = self.c
        det = self.det
        win, step = c.img_o_size, c.fddb_step
        L2 = self.params.landmark_dim

        levels = self._pyramid_m0(gray)
        layout = self._m0_layout(gray.shape[0], gray.shape[1])
        if not levels or not layout:
            return _empty(L2)
        key = ("ms0", win, step)
        if key not in self._tab_cache:
            self._tab_cache[key] = D0.node_tables_ms(
                det._ms32,
                det._host_stage0,
                win,
                step,
                (c.img_o_size, c.img_h_size, c.img_q_size),
                rounding=True,
            )
        base_tab = self._tab_cache[key]
        Hp = layout[-1][0] + layout[-1][1]
        canvas = np.zeros((Hp, gray.shape[1]), np.uint8)
        metas, tabs, xs_all, ys_all, lvl_all = [], [], [], [], []
        for li, ((y0, h, w), (img, _back)) in enumerate(zip(layout, levels)):
            canvas[y0 : y0 + img.shape[0], : img.shape[1]] = img
            ny = (h - win) // step + 1
            nx = (w - win) // step + 1
            metas.append((win, step, ny, nx))
            tabs.append(D0.shift_tables(base_tab, y0, 0, step))
            gy, gx = np.meshgrid(
                np.arange(ny, dtype=np.int32) * step,
                np.arange(nx, dtype=np.int32) * step,
                indexing="ij",
            )
            xs_all.append(gx.reshape(-1))
            ys_all.append(gy.reshape(-1))
            lvl_all.append(np.full(gx.size, li, np.int32))
        x = np.concatenate(xs_all)
        y = np.concatenate(ys_all)
        lvl = np.concatenate(lvl_all)
        _, alive0, nvis0 = D0.stage0_filter_all_scales_ms(
            torch.from_numpy(canvas).to(self.device)[None],
            tabs,
            meta=metas,
            depth=self.params.tree_depth,
        )
        alive0 = alive0[0].cpu().numpy()
        nvis0 = nvis0[0].cpu().numpy()
        n = len(x)
        stat.patch_n += n
        reject_nvis = int(nvis0[~alive0].sum())
        surv = np.flatnonzero(alive0)
        if len(surv) == 0:
            stat.nonface_patch_n += n
            stat.cart_gothrough_n += reject_nvis
            return _empty(L2)
        # survivors: per-window patches (the host path's rows) and the full
        # cascade; stage 0 runs again bit-exactly on the resized patches, so
        # dense + tail equals the host path
        rows = np.zeros(
            (len(surv), sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))),
            np.uint8,
        )
        for li in np.unique(lvl[surv]):
            at = np.flatnonzero(lvl[surv] == li)
            rows[at] = self._patch_rows(levels[li][0], x[surv[at]], y[surv[at]])
        alive, score, shape, nvis = self._validate_patches(rows)
        stat.face_patch_n += int(alive.sum())
        stat.nonface_patch_n += n - int(alive.sum())
        stat.cart_gothrough_n += reject_nvis + int(nvis[~alive].sum())
        keep = np.flatnonzero(alive)
        if not len(keep):
            return _empty(L2)
        sw = surv[keep]
        backs = np.asarray([b for _, b in levels], np.float64)[lvl[sw]]
        rects = np.stack(
            [
                (x[sw] * backs).astype(np.int32),
                (y[sw] * backs).astype(np.int32),
                (win * backs).astype(np.int32),
                (win * backs).astype(np.int32),
            ],
            1,
        ).astype(np.int32)
        return rects, score[keep].astype(np.float64), shape[keep].astype(np.float64)

    def _detect_m0_host(self, gray: np.ndarray, stat: DetectionStatistic):
        """Method 0 as the reference runs it: every window of every level
        resized to its o/h/q patches and validated, level by level."""
        c = self.c
        win = c.img_o_size
        step = c.fddb_step
        factor = c.fddb_scale_factor
        img = gray.copy()
        scale = 1.0
        all_rects, all_scores, all_shapes = [], [], []
        while img.shape[0] >= win and img.shape[1] >= win:
            gy, gx = np.meshgrid(
                np.arange(0, img.shape[0] - win + 1, step),
                np.arange(0, img.shape[1] - win + 1, step),
                indexing="ij",
            )
            gx = gx.reshape(-1)
            gy = gy.reshape(-1)
            if len(gx):
                alive, score, shape, nvis = self._validate_patches(
                    self._patch_rows(img, gx, gy)
                )
                stat.patch_n += len(gx)
                stat.face_patch_n += int(alive.sum())
                stat.nonface_patch_n += int((~alive).sum())
                stat.cart_gothrough_n += int(nvis[~alive].sum())
                keep = np.flatnonzero(alive)
                if len(keep):
                    all_rects.append(
                        np.stack(
                            [
                                (gx[keep] * scale).astype(np.int32),
                                (gy[keep] * scale).astype(np.int32),
                                np.full(len(keep), int(win * scale), np.int32),
                                np.full(len(keep), int(win * scale), np.int32),
                            ],
                            1,
                        )
                    )
                    all_scores.append(score[keep].astype(np.float64))
                    all_shapes.append(shape[keep].astype(np.float64))
            scale *= factor
            nw = int(img.shape[1] / factor)
            nh = int(img.shape[0] / factor)
            if nw < 1 or nh < 1:
                break
            img = R.cv2_resize(img, nw, nh)
        if not all_rects:
            return _empty(self.params.landmark_dim)
        return (
            np.concatenate(all_rects),
            np.concatenate(all_scores),
            np.concatenate(all_shapes),
        )

    # -- batched detection (the fddb throughput path) ------------------------

    def detect_batch(self, grays: List[np.ndarray]) -> List[Result]:
        """Batched `jda fddb` detection: every image of the batch shares one
        fused pass (ops/fused.py) on a canonical method-1 window ladder, or
        on packed method-0 pyramids, with C++ rounding semantics.  Exact for
        single-scale models (method-1 windows read only the origin plane
        then); multi-scale models, and any model the fused path does not
        serve, run image by image through detect().  The reference gets its
        fddb throughput from the OpenMP fold loop (src/test.cpp:100-101);
        here images are the batch axis."""
        with tracing.call("cpp_detect_batch", len(grays)):
            if not grays:
                return []
            if self.c.fddb_detect_method == 0:
                if self._m0_fast_applicable():
                    return self._detect_batch_m0(grays)
                return [self.detect(g) for g in grays]
            if not (self.det.single_scale and self.det._fused_enabled()):
                return [self.detect(g) for g in grays]
            return self._detect_batch_m1(grays)

    def _detect_batch_m0(self, grays, canon: Optional[Tuple[int, int]] = None):
        """Batched method 0: packed pyramids ride one fused pass, then per
        image NMS and landmark relocation (the same final block as
        detect(), cascador.cpp:448-474)."""
        return [
            _nms_relocate(self.c, rects, scores, shapes) + (stat,)
            for rects, scores, shapes, stat in self._detect_m0_raw_batch(
                grays, canon=canon
            )
        ]

    def _detect_batch_m1(
        self, grays, canon: Optional[Tuple[int, int]] = None
    ) -> List[Result]:
        """Batched method 1: the images top-left in canonical planes (at
        least `canon`), one fused pass over the canonical ladder, per-image
        window masks."""
        B = len(grays)
        Hc = max(g.shape[0] for g in grays)
        Wc = max(g.shape[1] for g in grays)
        if canon is not None:
            Hc, Wc = max(Hc, canon[0]), max(Wc, canon[1])
        plan = self._m1_plan(Hc, Wc)
        L2 = self.params.landmark_dim
        TK = self.params.T * self.params.K
        if plan["n"] == 0:
            return [_empty(L2) + (DetectionStatistic(),) for _ in grays]

        out = self.det._run(plan, grays, B)
        with tracing.span("harvest"):
            with tracing.span("harvest.wait"):
                sel = out["sel"].cpu().numpy()
            score = out["score"].cpu().numpy()
            shape = out["shape"].cpu().numpy()
            alive = out["alive"].cpu().numpy()
            # exact per-image visit banks (test.cpp:146-149 semantics)
            nvis_img = out["nvis_img"].cpu().numpy()

            n = plan["n"]
            x, y, win = plan["x"], plan["y"], plan["win"]
            bi = sel // n
            wi = sel % n
            results = []
            for i, g in enumerate(grays):
                mask_n = int(((x <= g.shape[1] - win) & (y <= g.shape[0] - win)).sum())
                m = alive & (bi == i)  # method 1 has no final score threshold
                cand = wi[m]
                rects = np.stack([x[cand], y[cand], win[cand], win[cand]], 1).astype(
                    np.int32
                )
                stat = DetectionStatistic(
                    patch_n=mask_n,
                    face_patch_n=len(cand),
                    nonface_patch_n=mask_n - len(cand),
                    cart_gothrough_n=int(nvis_img[i]) - len(cand) * TK,
                )
                results.append(
                    _nms_relocate(
                        self.c, rects, score[m].astype(np.float64),
                        shape[m].astype(np.float64),
                    )
                    + (stat,)
                )
            return results

    # -- public: JoinCascador::Detect (cascador.cpp:431-477) ----------------

    def detect(self, gray: np.ndarray) -> Result:
        """Returns (rects [n,4], scores [n], shapes [n,2L] absolute,
        statistic)."""
        with tracing.call("cpp_detect", 1):
            if gray.dtype != np.uint8 or gray.ndim != 2:
                raise ValueError("detect: gray must be a 2-D uint8 image")
            stat = DetectionStatistic()
            if self.c.fddb_detect_method == 0:
                rects, scores, shapes = self._detect_m0(gray, stat)
            else:
                rects, scores, shapes = self._detect_m1(gray, stat)
            return _nms_relocate(self.c, rects, scores, shapes) + (stat,)
