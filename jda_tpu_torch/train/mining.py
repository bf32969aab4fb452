"""Hard-negative mining screen on the device.

PyTorch counterpart of the JAX package's train/mining.py (DeviceMiner).
The reference mines negatives by cropping one window at a time from a
background image, resizing it and running the partial cascade on it
(data.cpp:885-1012, NegGenerator::NextImage + the OpenMP miner).  Here the
backgrounds live on the device and the screened windows never exist on
the host:

  * each scan state's current background is uploaded once into a slot of
    a resident [n_states, H, W] uint8 tensor;
  * a window (y, x, w) -> img_o_size crop + bilinear resize is a gather of
    the 2x2 source pixels of each output pixel and a two-tap float32 blend
    per axis (rows, then columns), with cv2.resize's INTER_LINEAR taps
    (`_bilinear_taps`);
  * the partial cascade (Trainer.make_validator's device core) runs on the
    synthesized rows in place; a verdict per window and two counts come
    back;
  * the accepted windows are re-cropped on the host with
    `ops/resize.cv2_resize` (OpenCV's exact pixels, data.cpp:957-960) and
    revalidated in one batch, so every row that enters the corpus equals
    the host mining path's.  The float blend may differ from OpenCV's
    11-bit fixed point in the last bit, which can flip a borderline
    verdict of the screen, never a stored row.

Window enumeration is exactly NegGenerator.next_window's stream; a
one-slot pushback per state lets each batch group a state's windows by
(background, window size).

CanvasHardMiner screens near-miss windows of host-rendered face canvases
(NegGenerator.load_canvas_factory) through the same synthesis with
truncation taps, whose blend gives the source pixel exactly: its o-plane
pixels equal the host rebuild's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from jda_tpu_torch.config import Config
from jda_tpu_torch.data import NegGenerator, _mined
from jda_tpu_torch.ops.resize import cv2_resize
from jda_tpu_torch.utils import resolve_device

Tensor = torch.Tensor


def _bilinear_taps(w: int, size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """2-tap row/col operators of cv2.resize(img[w, w], (size, size)),
    INTER_LINEAR: out[i] = wf0[i]*src[t0[i]] + wf1[i]*src[t1[i]]."""
    src = (np.arange(size, dtype=np.float64) + 0.5) * (w / size) - 0.5
    t0 = np.floor(src).astype(np.int64)
    frac = (src - t0).astype(np.float32)
    t0c = np.clip(t0, 0, w - 1)
    t1c = np.clip(t0 + 1, 0, w - 1)
    # when both taps clamp to the same pixel the weights must still sum to 1
    wf1 = np.where(t0 < 0, 1.0, np.where(t0 + 1 > w - 1, 0.0, frac)).astype(np.float32)
    return (
        t0c.astype(np.int32),
        t1c.astype(np.int32),
        (1.0 - wf1).astype(np.float32),
        wf1,
    )


def _make_synth(sizes: Tuple[int, ...], D: int):
    """Resident backgrounds + window parameters -> (flat rows, initial
    shapes, validity) of a screen batch, all on the device.

    sizes is the tuple of patch sizes to synthesize into the row: (o,) for
    single-scale models, (o, h, q) for multi-scale models (whose features
    read the half and quarter patches too, common.hpp:68-104); patch k lands
    at flat-row offset sum(sizes[:k]^2).

    synth(bgs [S, H, W] uint8, ys, xs [S, P] int64, taps {size: (t0, t1
    [S, size] int64, wf0, wf1 [S, size] f32)}, valid [S, P] bool,
    shift [S*P, 2] f32, ms [2L] f32)."""

    def synth(bgs, ys, xs, taps, valid, shift, ms):
        S, P = ys.shape
        _, H, W = bgs.shape
        flat = torch.zeros((S * P, D), dtype=torch.uint8, device=bgs.device)
        pixels = bgs.reshape(-1)
        slot = (torch.arange(S, device=bgs.device) * H)[:, None, None, None]
        off = 0
        for sz in sizes:
            t0, t1, wf0, wf1 = taps[sz]
            # flat offsets of the two source rows [S, P, sz, 1] and the two
            # source columns [S, P, 1, sz] of every output pixel
            r0 = (slot + (ys[:, :, None] + t0[:, None, :])[:, :, :, None]) * W
            r1 = (slot + (ys[:, :, None] + t1[:, None, :])[:, :, :, None]) * W
            c0 = (xs[:, :, None] + t0[:, None, :])[:, :, None, :]
            c1 = (xs[:, :, None] + t1[:, None, :])[:, :, None, :]
            a0 = wf0[:, None, :, None]  # row weights
            a1 = wf1[:, None, :, None]
            b0 = wf0[:, None, None, :]  # column weights
            b1 = wf1[:, None, None, :]

            def px(r, c):
                return pixels[r + c].to(torch.float32)

            left = a0 * px(r0, c0) + a1 * px(r1, c0)  # rows blended, column c0
            right = a0 * px(r0, c1) + a1 * px(r1, c1)
            patch = b0 * left + b1 * right  # [S, P, sz, sz]
            pix = torch.floor(patch + 0.5).clamp(0, 255).to(torch.uint8)
            flat[:, off : off + sz * sz] = pix.reshape(S * P, sz * sz)
            off += sz * sz
        # interleaved [x0, y0, x1, y1, ...]: tile the (x, y) shift
        shapes = ms[None, :] + shift.repeat(1, ms.shape[0] // 2)
        return flat.view(-1), shapes, valid.reshape(-1)

    return synth


def _pack_results(alive: Tensor, valid: Tensor, nvis: Tensor) -> Tensor:
    """[b + 2] int32: accepted lanes, rejected count, cart visits of the
    rejected (one transfer per screen batch)."""
    rej = ~alive & valid
    return torch.cat(
        [
            (alive & valid).to(torch.int32),
            rej.sum().to(torch.int32)[None],
            torch.where(rej, nvis, torch.zeros_like(nvis)).sum().to(torch.int32)[None],
        ]
    )


def _pack_canvas_results(alive: Tensor, valid: Tensor, nvis: Tensor) -> Tensor:
    """[b + 3] int32: `_pack_results` and the count of valid lanes (the
    difficulty ladder's denominator)."""
    return torch.cat([_pack_results(alive, valid, nvis), valid.sum().to(torch.int32)[None]])


def _crop_rows(acc, c: Config) -> np.ndarray:
    """Corpus rows of accepted windows (bg, y, x, w, shift): crops of one
    size are resized in one cv2_resize call each (bit-equal to one call
    per crop)."""
    D = sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))
    rows = np.zeros((len(acc), D), np.uint8)
    by_w: Dict[int, List[int]] = {}
    for i, a in enumerate(acc):
        by_w.setdefault(a[3], []).append(i)
    for w, ids in by_w.items():
        crops = np.stack([acc[i][0][acc[i][1] : acc[i][1] + w, acc[i][2] : acc[i][2] + w] for i in ids])
        rows[ids] = np.concatenate(
            [
                cv2_resize(crops, s, s).reshape(len(ids), -1)
                for s in (c.img_o_size, c.img_h_size, c.img_q_size)
            ],
            axis=1,
        )
    return rows


def _revalidate(acc, build_rows, validate, size: int):
    """The exact host rebuild and revalidation of accepted windows `acc`
    (each ending in its screen shift), in chunks of 4,096: rows from
    `build_rows(chunk)`, validated with the same shifts, and the first
    `size` accepted kept, so stored rows, scores and shapes never depend
    on the device's pixels.  Returns the (rows, scores, shapes) lists and
    the count kept."""
    rows_l, scores_l, shapes_l = [], [], []
    got = 0
    CH = 4096
    for i0 in range(0, len(acc), CH):
        chunk = acc[i0 : i0 + CH]
        rows = build_rows(chunk)
        ok, score, shape, _ = validate(rows, shift=np.stack([a[-1] for a in chunk]))
        take = np.flatnonzero(ok)[: size - got]
        if len(take):
            rows_l.append(rows[take])
            scores_l.append(score[take])
            shapes_l.append(shape[take])
            got += len(take)
        if got >= size:
            break
    return rows_l, scores_l, shapes_l, got


def _taps_dev(per_slot, dev) -> Tuple[Tensor, ...]:
    """Per-slot (t0, t1, wf0, wf1) taps of one patch size stacked to
    [S, size] tensors on `dev` (int64 indices, float32 weights)."""
    t0, t1, wf0, wf1 = (np.stack(a) for a in zip(*per_slot))
    return (
        torch.as_tensor(t0.astype(np.int64), device=dev),
        torch.as_tensor(t1.astype(np.int64), device=dev),
        torch.as_tensor(wf0, device=dev),
        torch.as_tensor(wf1, device=dev),
    )


class DeviceMiner:
    """Device-resident mining pipeline over a NegGenerator's scan states.

    Usable once the hard pool is drained (hard-pool patches have no
    backing background to synthesize from).  Multi-scale configs
    synthesize the half and quarter patches too; the exact host
    revalidation keeps the stored rows equal to the host mining path's
    either way.  Runs on CUDA unless given `device`.
    """

    def __init__(
        self,
        gen: NegGenerator,
        c: Config,
        per_state: int = 1024,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        self.gen = gen
        self.c = c
        self.P = per_state
        S = gen.n_states
        self._pending: List[Optional[Tuple[int, int, int, int]]] = [None] * S
        self._slot_ver = [-1] * S
        self._bgs_dev: Optional[Tensor] = None
        self._hw = (0, 0)
        self._taps_cache: Dict[Tuple[int, int], Tuple] = {}

    @property
    def applicable(self) -> bool:
        g = self.gen
        return all(st.hd_idx >= len(g.hards) for st in g.states)

    # -- proposal grouping ----------------------------------------------------

    def _collect(self):
        """One batch of proposals: per state, up to P windows sharing
        (background, win_size); a boundary-crossing window is pushed back
        for the next batch."""
        g = self.gen
        P = self.P
        groups = []
        for sid in range(g.n_states):
            st = g.states[sid]
            ys = np.zeros(P, np.int64)
            xs = np.zeros(P, np.int64)
            n = 0
            w0 = ver0 = bg0 = None
            if self._pending[sid] is not None:
                y, x, w, ver = self._pending[sid]
                self._pending[sid] = None
                w0, ver0 = w, ver
                bg0 = st.bg_img  # pending always belongs to the CURRENT bg
                ys[0], xs[0] = y, x
                n = 1
            while n < P:
                kind, payload = g.next_window(sid)
                if kind == "hard":
                    raise RuntimeError("hard pool entry in device miner")
                y, x, w = payload
                ver = st.bg_ver
                if w0 is None:
                    w0, ver0 = w, ver
                    bg0 = st.bg_img
                elif (w, ver) != (w0, ver0):
                    # boundary: st.bg_img may already be the NEXT bg; bg0
                    # pinned at group start keeps the group coherent
                    self._pending[sid] = (y, x, w, ver)
                    break
                ys[n], xs[n] = y, x
                n += 1
            groups.append(dict(sid=sid, ys=ys, xs=xs, n=n, w=w0, ver=ver0, bg=bg0))
        return groups

    # -- device residency -----------------------------------------------------

    def _ensure_bgs(self, groups) -> None:
        S = self.gen.n_states
        hmax = max([gr["bg"].shape[0] for gr in groups] + [self._hw[0]])
        wmax = max([gr["bg"].shape[1] for gr in groups] + [self._hw[1]])
        if self._bgs_dev is None or (hmax, wmax) != self._hw:
            self._hw = (hmax, wmax)
            buf = np.zeros((S, hmax, wmax), np.uint8)
            for gr in groups:
                bg = gr["bg"]
                buf[gr["sid"], : bg.shape[0], : bg.shape[1]] = bg
                self._slot_ver[gr["sid"]] = gr["ver"]
            self._bgs_dev = torch.from_numpy(buf).to(self.device)
            return
        for gr in groups:
            sid = gr["sid"]
            if self._slot_ver[sid] != gr["ver"]:
                bg = gr["bg"]
                pad = np.zeros(self._hw, np.uint8)
                pad[: bg.shape[0], : bg.shape[1]] = bg
                self._bgs_dev[sid] = torch.from_numpy(pad).to(self.device)
                self._slot_ver[sid] = gr["ver"]

    # -- main -----------------------------------------------------------------

    def generate(
        self,
        validate,
        size: int,
        max_batches: int = 2000,
        rng: Optional[np.random.Generator] = None,
    ):
        """Drop-in for NegGenerator.generate on the device path.  `validate`
        is Trainer.make_validator's closure (carries .validate_dev).  The
        statistics add `screened` (valid windows screened), `screen_s` and
        `revalidate_s` (host seconds of the screen and of the exact
        rebuild and revalidation)."""
        c = self.c
        g = self.gen
        S = g.n_states
        P = self.P
        b = S * P
        sizes = (
            (c.img_o_size, c.img_h_size, c.img_q_size)
            if c.multi_scale
            else (c.img_o_size,)
        )
        D = sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))
        rng = rng if rng is not None else np.random.default_rng(0)
        synth = _make_synth(sizes, D)
        dev = self.device

        acc = []  # (bg ref, y, x, w, shift)
        # over-collect slightly: exact revalidation drops borderline windows
        want = size + max(size // 16, 8)
        nega_n = 0
        carts_n = 0
        screened = 0
        n_batches = 0
        # one batch in flight: batch i is harvested after batch i+1 is
        # dispatched, as in the JAX package, so both packages collect the
        # same batches and draw the same shifts from `rng`
        pending = []
        t_screen = time.perf_counter()

        def harvest(entry):
            nonlocal nega_n, carts_n
            groups_h, shift_h, packed = entry
            arr = packed.cpu().numpy()
            nega_n += int(arr[b])
            carts_n += int(arr[b + 1])
            for flat_i in np.flatnonzero(arr[:b]):
                sid, p = divmod(int(flat_i), P)
                gr = groups_h[sid]
                acc.append((gr["bg"], int(gr["ys"][p]), int(gr["xs"][p]), gr["w"], shift_h[flat_i]))

        while len(acc) < want and n_batches < max_batches:
            n_batches += 1
            groups = self._collect()
            self._ensure_bgs(groups)
            # the JAX package draws the shifts of the whole padded batch
            shift = rng.uniform(-c.shift_size, c.shift_size, (b, 2)).astype(np.float32)
            ys = np.stack([gr["ys"] for gr in groups])
            xs = np.stack([gr["xs"] for gr in groups])
            valid = np.arange(P)[None, :] < np.asarray([gr["n"] for gr in groups])[:, None]
            screened += int(valid.sum())
            taps = {}
            for sz in sizes:
                for gr in groups:
                    key = (gr["w"], sz)
                    if key not in self._taps_cache:
                        self._taps_cache[key] = _bilinear_taps(gr["w"], sz)
                taps[sz] = _taps_dev([self._taps_cache[(gr["w"], sz)] for gr in groups], dev)
            flat_dev, shapes_dev, valid_dev = synth(
                self._bgs_dev,
                torch.as_tensor(ys, device=dev),
                torch.as_tensor(xs, device=dev),
                taps,
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(shift, device=dev),
                validate.ms_dev,
            )
            state = validate.validate_dev(flat_dev, shapes_dev, valid_dev, b)
            pending.append((groups, shift, _pack_results(state["alive"], valid_dev, state["nvis"])))
            if len(pending) > 1:
                harvest(pending.pop(0))
        for entry in pending:
            harvest(entry)
        screen_s = time.perf_counter() - t_screen

        # stored rows, scores and shapes equal the host mining path's
        t_host = time.perf_counter()
        rows_l, scores_l, shapes_l, got = _revalidate(
            acc, lambda chunk: _crop_rows(chunk, c), validate, size
        )
        stats = {
            "exhausted": got < size,
            "not_hard": nega_n,
            "avg_reject_carts": carts_n / max(nega_n, 1),
            "fp_rate": got / max(got + nega_n, 1),
            "bg_used": g.report_bg_used(),
            "screened": screened,
            "screen_s": screen_s,
            "revalidate_s": time.perf_counter() - t_host,
        }
        return _mined(rows_l, scores_l, shapes_l, stats, D, c.landmark_dim)


# ---------------------------------------------------------------------------
# Canvas-based near-miss mining
# ---------------------------------------------------------------------------

def _trunc_taps(w: int, size: int):
    """One-tap operators of the detection scan's truncated coordinate map
    patch[i] = src[(i * w) // size] (c/jda.c:375-381: windows are
    subsampled, never resized), as degenerate two-tap operators (wf0 = 1,
    wf1 = 0) so that _make_synth's blend gives the source pixel exactly."""
    t = ((np.arange(size, dtype=np.int64) * w) // size).astype(np.int32)
    return t, t, np.ones(size, np.float32), np.zeros(size, np.float32)


def _trunc_then_bilinear_taps(w: int, o_size: int, sz: int):
    """Composed taps of cv2-bilinear-resize(subsample(canvas, w -> o_size),
    o_size -> sz): the o-patch index of each bilinear tap is mapped through
    the truncation map, weights unchanged (both maps are separable)."""
    t = ((np.arange(o_size, dtype=np.int64) * w) // o_size).astype(np.int32)
    b0, b1, w0, w1 = _bilinear_taps(o_size, sz)
    return t[b0], t[b1], w0, w1


def _box_iou_vec(x0, y0, w, fx, fy, fs):
    """IoU of square windows (x0, y0, w) with the face box (fx, fy, fs)."""
    ix = np.maximum(0.0, np.minimum(x0 + w, fx + fs) - np.maximum(x0, fx))
    iy = np.maximum(0.0, np.minimum(y0 + w, fy + fs) - np.maximum(y0, fy))
    inter = ix * iy
    return inter / (w * w + fs * fs - inter)


def _subsample(canvas: np.ndarray, x0: int, y0: int, w: int, out: int):
    idx = (np.arange(out, dtype=np.int64) * w) // out
    return canvas[y0 + idx[:, None], x0 + idx[None, :]]


def _canvas_rows(acc, c: Config) -> np.ndarray:
    """Corpus rows of accepted canvas windows (canvas, y, x, w, shift):
    patch_row of each window's truncation subsample, every o-size patch of
    the chunk resized in one cv2_resize call per plane (bit-equal to one
    call per window)."""
    o = c.img_o_size
    subs = np.stack([_subsample(cv, x, y, w, o) for cv, y, x, w, _ in acc])
    return np.concatenate(
        [cv2_resize(subs, s, s).reshape(len(acc), -1) for s in (o, c.img_h_size, c.img_q_size)],
        axis=1,
    )


class CanvasHardMiner:
    """Device-batched near-miss mining from host-rendered face canvases.

    NegGenerator.generate_hard renders one candidate patch per host call.
    Here the host renders a face canvas (face + clutter margin) once, and
    the device extracts dozens to hundreds of candidate windows from it per
    batch through DeviceMiner's window synthesis with truncation taps, so
    the screen's o-plane pixels equal the detection scan's coordinate map
    and the host rebuild of accepted windows.

    Window geometry per canvas kind (NegGenerator.load_canvas_factory):
      * true face (any_window=False): windows with IoU in
        [lo(difficulty), 0.48] against the face box: off-scale, off-centre
        and boundary-IoU negatives in one sampler;
      * off-manifold face (any_window=True): registered windows (the
        positives' own scale and shift band): the face itself is the
        negative.

    Shares NegGenerator's adaptive difficulty ladder: acceptance below
    10 % raises the difficulty (the factory renders harder faces, the IoU
    band tightens toward 0.48), above 35 % lowers it.  The resident canvas
    buffer takes the largest canvas's true size, grows when a refresh brings
    a larger one, and re-uploads only the slots whose canvas changed.  Runs
    on CUDA unless given `device`."""

    def __init__(
        self,
        gen: NegGenerator,
        c: Config,
        n_slots: int = 16,
        per_slot: int = 256,
        device: Union[str, torch.device, None] = None,
    ):
        self.device = resolve_device(device)
        self.gen = gen
        self.c = c
        self.S = n_slots
        self.P = per_slot
        self.slots: List[Optional[dict]] = [None] * n_slots
        self._ver = [-1] * n_slots
        self._slot_ver = [-2] * n_slots  # version of each slot's device copy
        self._next_ver = 0
        self._refresh_ptr = 0
        self._canv_dev: Optional[Tensor] = None
        self._hw = 0
        self._taps_cache: Dict[Tuple[int, int], Tuple] = {}

    # -- host side ------------------------------------------------------------

    def _refresh(self, count: int) -> None:
        """Render `count` canvases into the next slots, round robin."""
        g = self.gen
        for _ in range(count):
            sid = self._refresh_ptr % self.S
            self._refresh_ptr += 1
            canvas, (fx, fy, fs), any_window = g.canvas_factory(
                g._canvas_cursor, g._hard_difficulty
            )
            g._canvas_cursor += 1
            self.slots[sid] = dict(
                canvas=np.ascontiguousarray(canvas, np.uint8),
                fx=int(fx),
                fy=int(fy),
                fs=int(fs),
                any=bool(any_window),
            )
            self._ver[sid] = self._next_ver
            self._next_ver += 1

    def _sample_windows(self, slot: dict, rng) -> Tuple[int, np.ndarray, np.ndarray, int]:
        """One window size and up to P origins for a slot, honouring its
        negative-window constraint.  Returns (w, ys, xs, n_valid).  Draws
        from `rng` in the JAX package's order and sizes."""
        P = self.P
        d = self.gen._hard_difficulty
        C = slot["canvas"].shape[0]
        fx, fy, fs = slot["fx"], slot["fy"], slot["fs"]
        fcx, fcy = fx + fs / 2.0, fy + fs / 2.0
        ys = np.zeros(P, np.int64)
        xs = np.zeros(P, np.int64)
        if slot["any"]:
            # registered windows of an off-manifold face: the positives'
            # own tolerance band (scale 0.95-1.2, centre +-5 %)
            w = int(round(fs * rng.uniform(0.92, 1.25)))
            w = max(24, min(w, C))
            cx = fcx + rng.uniform(-0.07, 0.07, P) * fs
            cy = fcy + rng.uniform(-0.07, 0.07, P) * fs
            xs[:] = np.clip(np.round(cx - w / 2), 0, C - w).astype(np.int64)
            ys[:] = np.clip(np.round(cy - w / 2), 0, C - w).astype(np.int64)
            return w, ys, xs, P
        # true face: boundary-IoU windows only; lo rises with difficulty so
        # that candidates track the cascade's decision boundary, clamped
        # under hi so that the band stays non-empty at the ladder's cap 2.0
        lo = min(0.22 + 0.20 * d, 0.44)
        hi = 0.48
        w = int(round(fs * rng.uniform(0.7, 1.6)))
        w = max(24, min(w, C))
        n = 0
        for _attempt in range(6):
            need = P - n
            if need <= 0:
                break
            k = need * 4
            ang = rng.uniform(0, 2 * np.pi, k)
            dist = rng.uniform(0.0, 0.75 * fs, k)
            cx = fcx + np.cos(ang) * dist
            cy = fcy + np.sin(ang) * dist
            x0 = np.clip(np.round(cx - w / 2), 0, C - w).astype(np.int64)
            y0 = np.clip(np.round(cy - w / 2), 0, C - w).astype(np.int64)
            iou = _box_iou_vec(x0, y0, w, fx, fy, fs)
            keep = np.flatnonzero((iou >= lo) & (iou <= hi))[:need]
            if len(keep):
                xs[n : n + len(keep)] = x0[keep]
                ys[n : n + len(keep)] = y0[keep]
                n += len(keep)
        return w, ys, xs, n

    # -- device residency -------------------------------------------------------

    def _ensure_dev(self) -> None:
        """The slots' canvases in a resident [S, C, C] uint8 tensor, C the
        largest canvas yet: rebuilt when a larger canvas arrives, else
        only the slots whose canvas changed are uploaded."""
        cmax = max([s["canvas"].shape[0] for s in self.slots] + [self._hw])
        if self._canv_dev is None or cmax != self._hw:
            self._hw = cmax
            buf = np.zeros((self.S, cmax, cmax), np.uint8)
            for sid, s in enumerate(self.slots):
                cv = s["canvas"]
                buf[sid, : cv.shape[0], : cv.shape[1]] = cv
                self._slot_ver[sid] = self._ver[sid]
            self._canv_dev = torch.from_numpy(buf).to(self.device)
            return
        for sid, s in enumerate(self.slots):
            if self._slot_ver[sid] != self._ver[sid]:
                pad = np.zeros((cmax, cmax), np.uint8)
                cv = s["canvas"]
                pad[: cv.shape[0], : cv.shape[1]] = cv
                self._canv_dev[sid] = torch.from_numpy(pad).to(self.device)
                self._slot_ver[sid] = self._ver[sid]

    def _taps(self, w: int, sz: int):
        key = (w, sz)
        if key not in self._taps_cache:
            o = self.c.img_o_size
            self._taps_cache[key] = (
                _trunc_taps(w, o) if sz == o else _trunc_then_bilinear_taps(w, o, sz)
            )
        return self._taps_cache[key]

    # -- main -------------------------------------------------------------------

    def generate(
        self,
        validate,
        size: int,
        max_batches: int = 200,
        rng: Optional[np.random.Generator] = None,
    ):
        """Same contract as NegGenerator.generate_hard: mine up to `size`
        accepted (row, score, shape) triples, every candidate validated by
        the current partial cascade (data.cpp:983-987).  `validate` is
        Trainer.make_validator's closure.  The statistics add `screened`
        (valid windows screened), `screen_s` (host seconds of the screen
        loop), `render_s` (of it, in the canvas factory) and `revalidate_s`
        (the exact host rebuild and revalidation)."""
        c = self.c
        g = self.gen
        if g.canvas_factory is None:
            raise RuntimeError("CanvasHardMiner: load_canvas_factory first")
        S, P = self.S, self.P
        b = S * P
        rng = rng if rng is not None else np.random.default_rng(0)
        o = c.img_o_size
        sizes = (o, c.img_h_size, c.img_q_size) if c.multi_scale else (o,)
        D = sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))
        synth = _make_synth(sizes, D)
        dev = self.device

        t_screen = time.perf_counter()
        render_s = 0.0
        if any(s is None for s in self.slots):
            self._refresh(S)
            render_s += time.perf_counter() - t_screen

        acc = []  # (canvas ref, y, x, w, shift)
        nega_n = 0
        carts_n = 0
        screened = 0
        n_batches = 0
        # one batch in flight, harvested after the next is dispatched, as in
        # the JAX package: the ladder moves at harvest, so the refresh and
        # the window sampling of batch i+1 see the difficulty before batch
        # i's verdict
        pending = []
        want = size + max(size // 16, 8)

        def harvest(entry):
            nonlocal nega_n, carts_n
            slots_h, shift_h, packed = entry
            arr = packed.cpu().numpy()
            nega_n += int(arr[b])
            carts_n += int(arr[b + 1])
            nvalid = int(arr[b + 2])
            accepted = np.flatnonzero(arr[:b])
            for flat_i in accepted:
                sid, p = divmod(int(flat_i), P)
                cv, w, ys, xs = slots_h[sid]
                acc.append((cv, int(ys[p]), int(xs[p]), w, shift_h[flat_i]))
            # adaptive difficulty, the policy of NegGenerator.generate_hard
            rate = len(accepted) / max(nvalid, 1)
            if rate < 0.10:
                g._hard_difficulty = min(2.0, g._hard_difficulty + 0.15)
            elif rate > 0.35:
                g._hard_difficulty = max(0.0, g._hard_difficulty - 0.05)

        while len(acc) < want and n_batches < max_batches:
            n_batches += 1
            if n_batches > 1:
                t = time.perf_counter()
                self._refresh(max(1, S // 4))
                render_s += time.perf_counter() - t
            self._ensure_dev()
            # the JAX package draws the shifts of the whole padded batch
            # first, then each slot's windows
            shift = rng.uniform(-c.shift_size, c.shift_size, (b, 2)).astype(np.float32)
            slots_h = []
            ns = []
            for slot in self.slots:
                w, ys, xs, n = self._sample_windows(slot, rng)
                slots_h.append((slot["canvas"], w, ys, xs))
                ns.append(n)
            screened += sum(ns)
            taps = {sz: _taps_dev([self._taps(sh[1], sz) for sh in slots_h], dev) for sz in sizes}
            valid = np.arange(P)[None, :] < np.asarray(ns)[:, None]
            flat_dev, shapes_dev, valid_dev = synth(
                self._canv_dev,
                torch.as_tensor(np.stack([sh[2] for sh in slots_h]), device=dev),
                torch.as_tensor(np.stack([sh[3] for sh in slots_h]), device=dev),
                taps,
                torch.as_tensor(valid, device=dev),
                torch.as_tensor(shift, device=dev),
                validate.ms_dev,
            )
            state = validate.validate_dev(flat_dev, shapes_dev, valid_dev, b)
            pending.append(
                (slots_h, shift, _pack_canvas_results(state["alive"], valid_dev, state["nvis"]))
            )
            if len(pending) > 1:
                harvest(pending.pop(0))
        for entry in pending:
            harvest(entry)
        screen_s = time.perf_counter() - t_screen

        t_host = time.perf_counter()
        rows_l, scores_l, shapes_l, got = _revalidate(
            acc, lambda chunk: _canvas_rows(chunk, c), validate, size
        )
        stats = {
            "exhausted": got < size,
            "not_hard": nega_n,
            "avg_reject_carts": carts_n / max(nega_n, 1),
            "fp_rate": got / max(got + nega_n, 1),
            "bg_used": 0,
            "difficulty": g._hard_difficulty,
            "screened": screened,
            "screen_s": screen_s,
            "render_s": render_s,
            "revalidate_s": time.perf_counter() - t_host,
        }
        return _mined(rows_l, scores_l, shapes_l, stats, D, c.landmark_dim)
