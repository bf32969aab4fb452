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

The hard-pool miners of the JAX package (CanvasHardMiner, the hard
factory and its difficulty ladder) are not ported yet (ROADMAP A.11b).
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
                per = []
                for gr in groups:
                    key = (gr["w"], sz)
                    if key not in self._taps_cache:
                        self._taps_cache[key] = _bilinear_taps(gr["w"], sz)
                    per.append(self._taps_cache[key])
                t0, t1, wf0, wf1 = (np.stack(a) for a in zip(*per))
                taps[sz] = (
                    torch.as_tensor(t0.astype(np.int64), device=dev),
                    torch.as_tensor(t1.astype(np.int64), device=dev),
                    torch.as_tensor(wf0, device=dev),
                    torch.as_tensor(wf1, device=dev),
                )
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

        # exact host rebuild + revalidation of the accepted windows (same
        # initial shifts), so stored rows/scores/shapes equal the host path's
        t_host = time.perf_counter()
        rows_l, scores_l, shapes_l = [], [], []
        got = 0
        CH = 4096
        for i0 in range(0, len(acc), CH):
            chunk = acc[i0 : i0 + CH]
            rows = _crop_rows(chunk, c)
            shifts = np.stack([a[4] for a in chunk])
            ok, score, shape, _ = validate(rows, shift=shifts)
            take = np.flatnonzero(ok)[: size - got]
            if len(take):
                rows_l.append(rows[take])
                scores_l.append(score[take])
                shapes_l.append(shape[take])
                got += len(take)
            if got >= size:
                break

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
