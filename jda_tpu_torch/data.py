"""Training data layer: corpus, similarity transform, hard-negative stream.

PyTorch counterpart of the JAX package's data.py.  As there, after the
reference's DataSet/NegGenerator (data.hpp, data.cpp):

  * the corpus is a structure-of-arrays: every sample's o/h/q patches are
    one flat row of a [N, D] uint8 matrix (D = so^2+sh^2+sq^2), addressable
    by the detection tail's (base, stride, pw, ph) scheme
    (train/features.py);
  * samples are not physically reordered: thresholds come from
    np.partition and removal is a boolean mask, compacted lazily;
  * all randomness is an explicit np.random.Generator.

The device mirrors are plain tensors on the trainer's device: the rows
are uploaded once as uint8, and mined-row appends and compactions run on
the device.  The host arrays stay the master copy, so binary corpus
snapshots are byte-identical to the JAX package's (and to the reference's
writeDataSet/readDataSet, data.cpp:698-834).

Every resize is `ops/resize.cv2_resize` (bit-exact against OpenCV's
INTER_LINEAR); only reading image files needs OpenCV.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from jda_tpu_torch.config import Config
from jda_tpu_torch.ops.resize import cv2_resize
from jda_tpu_torch.utils import require_cv2, resolve_device


# ---------------------------------------------------------------------------
# Similarity transform (STParameter, data.cpp:64-126)
# ---------------------------------------------------------------------------

def st_identity(n: int) -> np.ndarray:
    m = np.zeros((n, 2, 2))
    m[:, 0, 0] = m[:, 1, 1] = 1.0
    return m


def st_calc(shape1: np.ndarray, shape2: np.ndarray, enabled: bool) -> np.ndarray:
    """Batched STParameter::Calc: scale*rot matrices [N, 2, 2] mapping
    frame 2 -> frame 1 offsets (data.cpp:64-114).  Identity when the
    config disables similarity transforms (both shipped configs do)."""
    n = shape1.shape[0]
    if not enabled:
        return st_identity(n)
    x1 = shape1[:, 0::2]
    y1 = shape1[:, 1::2]
    x2 = shape2[:, 0::2]
    y2 = shape2[:, 1::2]
    tx1, ty1 = x1 - x1.mean(1, keepdims=True), y1 - y1.mean(1, keepdims=True)
    tx2, ty2 = x2 - x2.mean(1, keepdims=True), y2 - y2.mean(1, keepdims=True)
    s1 = np.sqrt((tx1**2 + ty1**2).sum(1))
    s2 = np.sqrt((tx2**2 + ty2**2).sum(1))
    scale = s1 / s2
    tx1n, ty1n = tx1 / s1[:, None], ty1 / s1[:, None]
    tx2n, ty2n = tx2 / s2[:, None], ty2 / s2[:, None]
    num = (ty1n * tx2n - tx1n * ty2n).sum(1)
    den = (tx1n * tx2n + ty1n * ty2n).sum(1)
    norm = np.sqrt(num**2 + den**2)
    sin_t = num / norm
    cos_t = den / norm
    m = np.zeros((n, 2, 2))
    m[:, 0, 0] = scale * cos_t
    m[:, 0, 1] = scale * -sin_t
    m[:, 1, 0] = scale * sin_t
    m[:, 1, 1] = scale * cos_t
    return m


def st_apply(m: np.ndarray, shapes: np.ndarray) -> np.ndarray:
    """Apply [N, 2, 2] transforms to [N, 2L] interleaved xy shapes."""
    n, L2 = shapes.shape
    xy = shapes.reshape(n, L2 // 2, 2)
    out = np.einsum("nij,nlj->nli", m, xy)
    return out.reshape(n, L2)


# ---------------------------------------------------------------------------
# Image helpers
# ---------------------------------------------------------------------------

def get_face(img: np.ndarray, x: int, y: int, w: int, h: int) -> np.ndarray:
    """Crop a bbox, black-filling out-of-range regions (data.cpp:542-565)."""
    rows, cols = img.shape
    if x >= 0 and y >= 0 and x + w < cols and y + h < rows:
        return img[y : y + h, x : x + w].copy()
    big = np.zeros((3 * rows, 3 * cols), np.uint8)
    big[rows : 2 * rows, cols : 2 * cols] = img
    return big[y + rows : y + rows + h, x + cols : x + cols + w].copy()


def patch_row(face: np.ndarray, c: Config) -> np.ndarray:
    """One corpus row: o/h/q patches resized (cv2.resize INTER_LINEAR, as
    the reference) and concatenated flat."""
    return np.concatenate(
        [
            cv2_resize(face, s, s).reshape(-1)
            for s in (c.img_o_size, c.img_h_size, c.img_q_size)
        ]
    )


# ---------------------------------------------------------------------------
# DataSet
# ---------------------------------------------------------------------------

class DataSet:
    """Training corpus (positives or negatives): SoA arrays on the host
    with lazily built mirrors on `device` (resolved at first use, so a
    corpus that is only read or written needs no card)."""

    def __init__(
        self,
        c: Config,
        is_pos: bool,
        device: Union[str, torch.device, None] = None,
    ):
        self.c = c
        self.is_pos = is_pos
        self.device = device
        self.dims = (c.img_o_size, c.img_h_size, c.img_q_size)
        self.D = sum(d * d for d in self.dims)
        L2 = c.landmark_dim
        self.imgs = np.zeros((0, self.D), np.uint8)
        self.gt_shapes = np.zeros((0, L2))
        self.shape_mask = np.zeros(0, np.int32)
        self.current_shapes = np.zeros((0, L2))
        self.scores = np.zeros(0)
        self.last_scores = np.zeros(0)
        self.weights = np.zeros(0)
        self.stp_mc = np.zeros((0, 2, 2))
        self.stp_cm = np.zeros((0, 2, 2))
        self.mean_shape: Optional[np.ndarray] = None
        self.live = np.zeros(0, bool)
        self._rows_dev: Optional[torch.Tensor] = None  # [n, D] uint8
        self._shapes_dev: Optional[torch.Tensor] = None  # [n, 2L] f32
        self._stp_dev: Optional[torch.Tensor] = None  # [n, 2, 2] f32

    @property
    def size(self) -> int:
        """Count of live samples (dead rows await lazy compaction)."""
        return int(self.live.sum())

    def live_idx(self) -> np.ndarray:
        return np.flatnonzero(self.live)

    # -- device mirrors -------------------------------------------------------

    def invalidate(self):
        self._rows_dev = None
        self.invalidate_shapes()

    def invalidate_shapes(self):
        """Drop the per-sample shape-state mirrors.  Must be called after
        any host mutation of current_shapes/stp_mc that is not an append
        or a compaction (global regression, snapshot load)."""
        self._shapes_dev = None
        self._stp_dev = None

    def _dev(self) -> torch.device:
        return resolve_device(self.device)

    def rows_dev(self) -> torch.Tensor:
        """[n, D] uint8 mirror of the physical rows (dead rows included)."""
        if self._rows_dev is None:
            self._rows_dev = torch.from_numpy(
                np.ascontiguousarray(self.imgs, np.uint8)
            ).to(self._dev())
        return self._rows_dev

    def flat_dev(self) -> torch.Tensor:
        """The rows as one flat uint8 buffer: sample i's scale-s patch
        starts at i*D + offset[s] (train/features.corpus_geometry)."""
        return self.rows_dev().view(-1)

    def canvas_dev(self) -> torch.Tensor:
        """The ORIGIN-scale patches as an [n, S, S] uint8 view of the rows
        (feature_values_mxu reads single-scale features from it)."""
        S = self.dims[0]
        return self.rows_dev()[:, : S * S].unflatten(1, (S, S))

    def shapes_dev(self) -> torch.Tensor:
        """[n, 2L] float32 mirror of current_shapes.  Feature coordinates
        are computed from THIS float32 copy, as in the JAX package: never
        from the float64 host array."""
        if self._shapes_dev is None:
            self._shapes_dev = torch.from_numpy(
                self.current_shapes.astype(np.float32)
            ).to(self._dev())
        return self._shapes_dev

    def stp_dev(self) -> Optional[torch.Tensor]:
        """[n, 2, 2] float32 mirror of stp_mc (None when similarity
        transforms are disabled, as in the shipped configs)."""
        if not self.c.with_similarity_transform:
            return None
        if self._stp_dev is None:
            self._stp_dev = torch.from_numpy(self.stp_mc.astype(np.float32)).to(
                self._dev()
            )
        return self._stp_dev

    def _dev_append(self, rows_u8: np.ndarray, shapes: np.ndarray) -> None:
        """Mirror an append of `rows_u8` and their current shapes onto the
        live mirrors: only the new rows cross to the device."""
        if len(rows_u8) == 0:
            return
        if self._rows_dev is not None:
            new = torch.from_numpy(np.ascontiguousarray(rows_u8)).to(self._rows_dev.device)
            self._rows_dev = torch.cat([self._rows_dev, new])
        if self._shapes_dev is not None:
            new = torch.from_numpy(shapes.astype(np.float32)).to(self._shapes_dev.device)
            self._shapes_dev = torch.cat([self._shapes_dev, new])
        # calc_st_parameters recomputes EVERY row's stp after an append
        self._stp_dev = None

    def _dev_compact(self, keep_idx: np.ndarray) -> None:
        """Mirror a host compaction (imgs = imgs[keep_idx]) on the device."""
        for attr in ("_rows_dev", "_shapes_dev", "_stp_dev"):
            buf = getattr(self, attr)
            if buf is not None:
                idx = torch.from_numpy(keep_idx.astype(np.int64)).to(buf.device)
                setattr(self, attr, buf.index_select(0, idx))

    # -- loading --------------------------------------------------------------

    def load_positive(self, face_txt: str, rng: np.random.Generator) -> None:
        """LoadPositiveDataSet (data.cpp:567-678): token-stream parse of
        `path x y w h lm1x lm1y ...`, bbox crop with black fill, landmark
        normalization to [0,1], optional flip augment with symmetric
        landmark swap, mean shape, random initial shapes."""
        cv2 = require_cv2("DataSet.load_positive reads image files")
        c = self.c
        L = c.landmark_n
        with open(face_txt) as f:
            toks = f.read().split()
        stride = 5 + 2 * L
        if len(toks) % stride:
            raise ValueError(f"malformed {face_txt}: {len(toks)} tokens")
        n = len(toks) // stride

        rows, gts, masks = [], [], []
        for i in range(n):
            rec = toks[i * stride : (i + 1) * stride]
            path = rec[0]
            x, y, w, h = (int(float(v)) for v in rec[1:5])
            lm = np.asarray([float(v) for v in rec[5:]], np.float64)
            mask = -1 if (lm < 0).all() else 1
            img = cv2.imread(path)
            if img is None:
                raise IOError(f"can not open {path}")
            gray = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
            face = get_face(gray, x, y, w, h)
            lm[0::2] = (lm[0::2] - x) / w
            lm[1::2] = (lm[1::2] - y) / h
            rows.append(patch_row(face, c))
            gts.append(lm)
            masks.append(mask)
            if c.face_augment_on:
                rows.append(patch_row(face[:, ::-1], c))
                flm = lm.copy()
                flm[0::2] = 1 - flm[0::2]
                left, right = c.symmetric_landmarks
                for a, b in zip(left, right):
                    fa = flm[2 * a : 2 * a + 2].copy()
                    flm[2 * a : 2 * a + 2] = flm[2 * b : 2 * b + 2]
                    flm[2 * b : 2 * b + 2] = fa
                gts.append(flm)
                masks.append(mask)

        self.imgs = np.stack(rows).astype(np.uint8)
        self.gt_shapes = np.stack(gts)
        self.shape_mask = np.asarray(masks, np.int32)
        m = len(self.imgs)
        self.scores = np.zeros(m)
        self.last_scores = np.zeros(m)
        self.weights = np.zeros(m)
        self.stp_mc = st_identity(m)
        self.stp_cm = st_identity(m)
        self.live = np.ones(m, bool)
        self.calc_mean_shape()
        self.current_shapes = self.random_shapes(rng)
        self.invalidate()

    def calc_mean_shape(self) -> np.ndarray:
        valid = self.shape_mask == 1
        self.mean_shape = self.gt_shapes[valid].mean(0)
        return self.mean_shape

    def random_shapes(self, rng: np.random.Generator) -> np.ndarray:
        """Mean shape + per-sample global uniform shift (data.cpp:225-253)."""
        s = self.c.shift_size
        shift = rng.uniform(-s, s, (len(self.imgs), 2))
        out = np.tile(self.mean_shape, (len(self.imgs), 1))
        out[:, 0::2] += shift[:, 0:1]
        out[:, 1::2] += shift[:, 1:2]
        return out

    # -- boosting state ops (data.cpp:255-448) --------------------------------

    def update_weights_local(self):
        flag = -1.0 if self.is_pos else 1.0
        self.weights[self.live] = np.exp(flag * self.scores[self.live])

    # RealBoost weights are quantized to multiples of 2^-23 after the joint
    # normalization (sum == 1).  Every float32 sum of such values (split
    # histograms, cumulative sums over bins, atomics on the card) is then
    # EXACT in any association order, so the split search makes the same
    # decisions on the card, on the CPU and in the JAX package.
    WEIGHT_FRAC_BITS = 23

    @staticmethod
    def update_weights(pos: "DataSet", neg: "DataSet"):
        pos.update_weights_local()
        neg.update_weights_local()
        total = pos.weights[pos.live].sum() + neg.weights[neg.live].sum()
        if not np.isfinite(total) or total <= 0.0:
            # degenerate pools (exp under/overflow after one side emptied):
            # uniform weights keep the boosting state finite
            n_live = pos.size + neg.size
            pos.weights[pos.live] = 1.0 / max(n_live, 1)
            neg.weights[neg.live] = 1.0 / max(n_live, 1)
        else:
            pos.weights[pos.live] /= total
            neg.weights[neg.live] /= total
        q = float(1 << DataSet.WEIGHT_FRAC_BITS)
        pos.weights[pos.live] = np.round(pos.weights[pos.live] * q) / q
        neg.weights[neg.live] = np.round(neg.weights[neg.live] * q) / q
        pos.weights[~pos.live] = 0.0
        neg.weights[~neg.live] = 0.0

    def calc_threshold_by_rate(self, rate: float) -> float:
        """Score at the (1-rate) quantile from the top (data.cpp:330-334)."""
        s = np.sort(self.scores[self.live])[::-1]
        off = len(s) - 1 - int(rate * len(s))
        return float(s[max(off, 0)])

    def calc_threshold_by_number(self, remove: int) -> float:
        """Score of the `remove`-th lowest sample (data.cpp:335-345)."""
        s = self.scores[self.live]
        k = min(remove, len(s) - 1)
        return float(np.partition(s, k)[k])

    def pre_remove(self, th: float) -> int:
        return int((self.scores[self.live] < th).sum())

    def remove(self, th: float) -> None:
        """Drop live samples scoring below th (data.cpp:347-378): rows are
        mask-killed and compacted once fewer than half are live."""
        self.live &= self.scores >= th
        if len(self.imgs) and self.size < 0.5 * len(self.imgs):
            self.compact()

    def compact(self) -> None:
        keep = self.live
        self._dev_compact(np.flatnonzero(keep))
        self.imgs = self.imgs[keep]
        if self.is_pos:
            self.gt_shapes = self.gt_shapes[keep]
            self.shape_mask = self.shape_mask[keep]
        self.current_shapes = self.current_shapes[keep]
        self.scores = self.scores[keep]
        self.last_scores = self.last_scores[keep]
        self.weights = self.weights[keep]
        self.stp_mc = self.stp_mc[keep]
        self.stp_cm = self.stp_cm[keep]
        self.live = np.ones(len(self.imgs), bool)

    def reset_scores(self):
        self.scores = self.last_scores.copy()

    @staticmethod
    def calc_mean_std(pos: "DataSet", neg: "DataSet") -> Tuple[float, float]:
        s = np.concatenate([pos.scores[pos.live], neg.scores[neg.live]])
        return float(s.mean()), float(s.std())

    def apply_mean_std(self, mean: float, std: float):
        self.scores[self.live] = (self.scores[self.live] - mean) / std

    def calc_st_parameters(self, mean_shape: np.ndarray):
        en = self.c.with_similarity_transform
        n = len(self.imgs)
        ms = mean_shape[None].repeat(n, 0)
        self.stp_mc = st_calc(self.current_shapes, ms, en)
        self.stp_cm = st_calc(ms, self.current_shapes, en)
        self._stp_dev = None

    def shape_residual(self, idx: np.ndarray, landmark_id: Optional[int] = None) -> np.ndarray:
        """gt - current in the mean-shape frame (data.cpp:175-208)."""
        res = self.gt_shapes[idx] - self.current_shapes[idx]
        if landmark_id is None:
            return st_apply(self.stp_cm[idx], res)
        r = res[:, 2 * landmark_id : 2 * landmark_id + 2]
        return np.einsum("nij,nj->ni", self.stp_cm[idx], r)

    def append_negatives(
        self,
        rows: np.ndarray,
        scores: np.ndarray,
        shapes: np.ndarray,
        mean_shape: np.ndarray,
    ) -> None:
        """MoreNegSamples tail (data.cpp:479-532): mined patches enter with
        their cascade score and partially-regressed shape."""
        if self.is_pos:
            raise ValueError("append_negatives on a positive corpus")
        m = len(rows)
        self._dev_append(rows.astype(np.uint8), shapes)
        self.imgs = np.concatenate([self.imgs, rows.astype(np.uint8)])
        self.current_shapes = np.concatenate([self.current_shapes, shapes])
        self.scores = np.concatenate([self.scores, scores])
        self.last_scores = np.concatenate([self.last_scores, np.zeros(m)])
        self.weights = np.concatenate([self.weights, np.zeros(m)])
        self.stp_mc = np.concatenate([self.stp_mc, st_identity(m)])
        self.stp_cm = np.concatenate([self.stp_cm, st_identity(m)])
        self.live = np.concatenate([self.live, np.ones(m, bool)])
        self.calc_st_parameters(mean_shape)

    # -- binary snapshot, bit-compatible with writeDataSet/readDataSet --------

    def write_to(self, fout) -> None:
        self.compact()
        np.asarray([1 if self.is_pos else 0, self.size], "<i4").tofile(fout)
        if self.is_pos:
            self.mean_shape.astype("<f8").tofile(fout)
        for i in range(self.size):
            off = 0
            for d in self.dims:
                np.asarray([d, d], "<i4").tofile(fout)
                self.imgs[i, off : off + d * d].tofile(fout)
                off += d * d
            if self.is_pos:
                np.asarray([self.shape_mask[i]], "<i4").tofile(fout)
                self.gt_shapes[i].astype("<f8").tofile(fout)
            self.current_shapes[i].astype("<f8").tofile(fout)
            np.asarray([self.scores[i], self.weights[i]], "<f8").tofile(fout)

    def read_from(self, fin) -> None:
        L2 = self.c.landmark_dim
        flag, n = np.fromfile(fin, "<i4", 2)
        self.is_pos = bool(flag)
        if self.is_pos:
            self.mean_shape = np.fromfile(fin, "<f8", L2)
        rows = np.zeros((n, self.D), np.uint8)
        gts = np.zeros((n, L2))
        masks = np.zeros(n, np.int32)
        curs = np.zeros((n, L2))
        scores = np.zeros(n)
        weights = np.zeros(n)
        for i in range(n):
            off = 0
            for _ in range(3):
                cols, rws = np.fromfile(fin, "<i4", 2)
                rows[i, off : off + cols * rws] = np.fromfile(fin, np.uint8, cols * rws)
                off += cols * rws
            if self.is_pos:
                masks[i] = np.fromfile(fin, "<i4", 1)[0]
                gts[i] = np.fromfile(fin, "<f8", L2)
            curs[i] = np.fromfile(fin, "<f8", L2)
            scores[i], weights[i] = np.fromfile(fin, "<f8", 2)
        self.imgs = rows
        self.gt_shapes = gts
        self.shape_mask = masks
        self.current_shapes = curs
        self.scores = scores
        self.last_scores = np.zeros(n)
        self.weights = weights
        self.stp_mc = st_identity(n)
        self.stp_cm = st_identity(n)
        self.live = np.ones(n, bool)
        self.invalidate()

    @staticmethod
    def snapshot(pos: "DataSet", neg: "DataSet", path: str) -> None:
        with open(path, "wb") as f:
            pos.write_to(f)
            neg.write_to(f)

    @staticmethod
    def resume(path: str, pos: "DataSet", neg: "DataSet") -> None:
        with open(path, "rb") as f:
            pos.read_from(f)
            neg.read_from(f)


# ---------------------------------------------------------------------------
# NegGenerator: streaming hard-negative proposals (data.cpp:880-1197)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _ScanState:
    current_idx: int
    x: int = 0
    y: int = 0
    win_size: int = 0
    factor: float = 1.2
    step: int = 4
    transform_type: int = 0
    reset: int = 0
    hd_idx: int = 0
    bg_img: Optional[np.ndarray] = None
    bg_ver: int = 0  # bumped on every bg_img change (device-miner cache key)
    # per-state stream (like the reference's per-thread cv::RNGs,
    # common.cpp:233-238), so the window stream is invariant to how states
    # are interleaved into batches
    rng: Optional[np.random.Generator] = None


class NegGenerator:
    """Sliding-window proposal stream over background images.

    The reference runs thread_n OpenMP workers each owning a scan state and
    validating one window at a time (data.cpp:971-1012).  Here the same
    state machines produce batches of candidate patches that the partial
    cascade accepts or rejects in bulk.
    """

    def __init__(self, c: Config, n_states: int = 8):
        self.c = c
        self.n_states = n_states
        self.list: List[str] = []
        self.hards: List[np.ndarray] = []
        self.states: List[_ScanState] = []
        self._loader: Callable[[str], Optional[np.ndarray]] = self._imread

    @staticmethod
    def _imread(path: str) -> Optional[np.ndarray]:
        cv2 = require_cv2("NegGenerator reads background image files")
        return cv2.imread(path, cv2.IMREAD_GRAYSCALE)

    def load(self, bg_txts: Sequence[str], rng: np.random.Generator) -> None:
        """NegGenerator::Load (data.cpp:1067-1196): bg_txts[0] is the hard
        pool (text list or binary cache, consumed first when
        config.use_hard), the rest are background image lists."""
        self.list = []
        for p in bg_txts[1:]:
            with open(p) as f:
                self.list.extend(f.read().split())
        rng.shuffle(self.list)
        self.hards = []
        if self.c.use_hard and bg_txts:
            self._load_hard(bg_txts[0], rng)
        self._init_states(rng)

    def _load_hard(self, path: str, rng: np.random.Generator) -> None:
        c = self.c
        if path.endswith("txt"):
            cv2 = require_cv2("NegGenerator reads hard-negative image files")
            with open(path) as f:
                names = f.read().split()
            for nm in names:
                img = cv2.imread(nm, cv2.IMREAD_GRAYSCALE)
                if img is None:
                    continue
                self.hards.append(cv2_resize(img, c.img_o_size, c.img_o_size))
            # binary cache, reference hard.data format (data.cpp:1149-1167)
            with open(os.path.join(os.path.dirname(path), "hard.data"), "wb") as f:
                np.asarray([len(self.hards)], "<i4").tofile(f)
                for img in self.hards:
                    np.asarray([img.shape[1], img.shape[0]], "<i4").tofile(f)
                    img.astype(np.uint8).tofile(f)
        else:
            with open(path, "rb") as f:
                (n,) = np.fromfile(f, "<i4", 1)
                for _ in range(int(n)):
                    cols, rws = np.fromfile(f, "<i4", 2)
                    if cols == 0 or rws == 0:
                        continue
                    self.hards.append(
                        np.fromfile(f, np.uint8, cols * rws).reshape(rws, cols)
                    )
        rng.shuffle(self.hards)

    def load_images(self, images: List[np.ndarray], rng: np.random.Generator) -> None:
        """In-memory variant (tests / embedded use)."""
        self.list = [f"<mem:{i}>" for i in range(len(images))]
        self._mem = images
        self._loader = lambda p: self._mem[int(p[5:-1])]
        self._init_states(rng)

    def load_factory(
        self,
        factory: Callable[[int], np.ndarray],
        rng: np.random.Generator,
        virtual_n: int = 65536,
    ) -> None:
        """Unbounded background supply: image i is `factory(i)` (must be
        deterministic per index), generated lazily with a small LRU so the
        scan states can wrap a virtually-infinite list."""
        self.list = [f"<gen:{i}>" for i in range(virtual_n)]
        cached = functools.lru_cache(maxsize=1024)(factory)
        self._loader = lambda p: cached(int(p[5:-1]))
        self._init_states(rng)

    def _init_states(self, rng: np.random.Generator) -> None:
        c = self.c
        self.states = []
        for i in range(self.n_states):
            s = _ScanState(current_idx=i % max(len(self.list), 1))
            s.rng = np.random.default_rng(rng.integers(2**63))
            s.win_size = c.img_o_size
            s.factor = s.rng.uniform(1.1, 1.5)
            s.step = int(s.rng.integers(2, c.img_q_size))
            s.bg_img = self._loader(self.list[s.current_idx])
            s.hd_idx = i
            self.states.append(s)
        self._rng = rng

    @staticmethod
    def _transform(img: np.ndarray, t: int) -> np.ndarray:
        """The eight flips and transposes of the reference's background
        augmentation (cv::flip / cv::transpose, data.cpp:938-953)."""
        out = (
            img,
            img[::-1].T,  # transpose(flip(img, 0))
            img[::-1, ::-1],  # flip(img, -1)
            img[:, ::-1].T,  # transpose(flip(img, 1))
            img[:, ::-1],  # flip(img, 1)
            img[::-1, ::-1].T,  # transpose(flip(img, -1))
            img[::-1],  # flip(flip(img, -1), 1)
            img[::-1].T[:, ::-1],  # flip(transpose(flip(img, 0)), 1)
        )[t]
        return out if t == 0 else np.ascontiguousarray(out)

    def next_patch(self, sid: int) -> np.ndarray:
        """NextImage (data.cpp:885-966): one square candidate patch."""
        kind, payload = self.next_window(sid)
        if kind == "hard":
            return payload
        y, x, w = payload
        s = self.states[sid]
        return s.bg_img[y : y + w, x : x + w].copy()

    def next_window(self, sid: int):
        """Advance state `sid` one step; return ("hard", patch) for a
        hard-pool entry or ("scan", (y, x, win_size)) for a window of the
        state's CURRENT bg_img (the device miner synthesizes the crop and
        resize on the device from a resident background)."""
        s = self.states[sid]
        c = self.c
        if s.hd_idx < len(self.hards):
            patch = self.hards[s.hd_idx]
            s.hd_idx += self.n_states
            return "hard", patch
        s.x += s.step
        if s.x + s.win_size > s.bg_img.shape[1]:
            s.x = 0
            s.y += s.step
            if s.y + s.win_size > s.bg_img.shape[0]:
                s.y = 0
                s.win_size = int(s.win_size * s.factor)
                if s.win_size >= s.bg_img.shape[1] or s.win_size >= s.bg_img.shape[0]:
                    s.win_size = c.img_o_size
                    s.factor = s.rng.uniform(1.1, 1.5)
                    s.step = int(s.rng.integers(2, c.img_q_size))
                    # the reference's advance loop (data.cpp:913-925) never
                    # loads an image on the wraparound iteration, so it
                    # spins forever when list size <= thread stride; this
                    # loads after wrapping (and bounds pathological lists)
                    for _ in range(8 * len(self.list) + 8):
                        s.current_idx += self.n_states
                        if s.current_idx >= len(self.list):
                            s.current_idx %= len(self.list)
                            s.transform_type = (s.transform_type + 1) % 8
                            s.reset += 1
                        img = self._loader(self.list[s.current_idx])
                        if (
                            img is not None
                            and img.shape[1] > s.win_size
                            and img.shape[0] > s.win_size
                        ):
                            s.bg_img = self._transform(img, s.transform_type)
                            s.bg_ver += 1
                            break
                    else:
                        raise RuntimeError(
                            "no background image larger than the scan window"
                        )
        return "scan", (s.y, s.x, s.win_size)

    def report_bg_used(self) -> int:
        base = max(len(self.list), 1) // self.n_states
        return sum(
            s.current_idx // self.n_states + s.reset * base for s in self.states
        )

    def generate(
        self,
        validate_fn: Callable,
        size: int,
        batch: int = 512,
        max_batches: int = 2000,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
        """Mine up to `size` accepted patches.  validate_fn(rows [B, D]
        uint8) -> (is_face [B] bool, score [B], shape [B, 2L], nvis [B]).
        Returns (rows, scores, shapes, stats).

        max_batches bounds the proposal stream: the reference spins forever
        when the background pool has no hard negatives left
        (data.cpp:971-1012); this reports the shortfall instead."""
        c = self.c
        D = sum(d * d for d in (c.img_o_size, c.img_h_size, c.img_q_size))
        acc_rows, acc_scores, acc_shapes = [], [], []
        nega_n = 0
        carts_n = 0
        got = 0
        n_batches = 0
        while got < size and n_batches < max_batches:
            n_batches += 1
            rows = np.zeros((batch, D), np.uint8)
            for b in range(batch):
                rows[b] = patch_row(self.next_patch(b % self.n_states), c)
            ok, score, shape, nvis = validate_fn(rows)
            nega_n += int((~ok).sum())
            carts_n += int(nvis[~ok].sum())
            take = np.flatnonzero(ok)[: size - got]
            if len(take):
                acc_rows.append(rows[take])
                acc_scores.append(score[take])
                acc_shapes.append(shape[take])
                got += len(take)
        stats = {
            "exhausted": got < size,
            "not_hard": nega_n,
            "avg_reject_carts": carts_n / max(nega_n, 1),
            "fp_rate": got / max(got + nega_n, 1),
            "bg_used": self.report_bg_used(),
        }
        return _mined(acc_rows, acc_scores, acc_shapes, stats, D, c.landmark_dim)


def _mined(rows_l, scores_l, shapes_l, stats, D, L2):
    """The (rows, scores, shapes, stats) result of a mining call."""
    if not rows_l:
        return np.zeros((0, D), np.uint8), np.zeros(0), np.zeros((0, L2)), stats
    return (
        np.concatenate(rows_l),
        np.concatenate(scores_l),
        np.concatenate(shapes_l),
        stats,
    )
