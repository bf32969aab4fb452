"""Sample-sharded training ops: the multi-device Trainer's compute path.

PyTorch counterpart of the JAX package's train/sharded.py, in PyTorch's
own SPMD idiom: one process per device, every rank running the same
program with the same config and seed over a 1-D `DeviceMesh` whose
dimension is "dp".  The corpus and the host state (the generator, the
DataSet arrays, the model, the mining cursors) are replicated on every
rank; the per-node work is split over the sample axis:

  * classification split: each rank histograms the rows of its slab, one
    all-reduce sums (wp, cp, wn, cn, pos_n, neg_n), and every rank takes
    the same decision (split.classification_split_from_hists);
  * regression split: one all-reduce of the count histograms and pos_n
    gives every rank the exact percentile thresholds (the histogram's CDF
    crossing equals the sorted order statistic), one more of the
    objective's sufficient statistics (split.regression_sums) gives the
    decision;
  * the chosen feature's value columns are gathered, so that every rank
    partitions the node's rows as one device would;
  * tree descent (score updates, LBF) runs on the slab with no
    collective; leaves and leaf scores are gathered;
  * the LBF ridge: each rank builds the normal equations of its slab, one
    all-reduce sums (A, b), and every rank solves the same system.

Collectives per call: classification split 2 (histograms, columns),
regression split 3 (counts, sums, columns), descent 1, ridge 1.  Only
`all_reduce(SUM)` runs on tensors (a gather is the sum of zero-filled
buffers in which each rank writes its own slab, floats carried as their
int32 bits), so NCCL and gloo on CUDA tensors both serve every op.

Why every result equals the single-device trainer's bit for bit: boosting
weights are multiples of 2^-23 (DataSet.update_weights), residuals are
rounded to multiples of 2^-10 (split.quantize_residual), counts are
integers, and the decisions read only those sums.  A float32 sum of such
values is exact while every partial sum stays below 2^24 quanta (2^14 in
residual units; ShardedOps.max_abs_sum records the largest total seen), so
it is the same in any order and any partition of the rows.  The ridge's
(A, b) are counts and such residual sums, so W is the same solve of the
same system.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.train import regression as RG
from jda_tpu_torch.train import split as SP
from jda_tpu_torch.utils import block, dp_mesh

Tensor = torch.Tensor


class ShardedOps:
    """Mesh-bound training ops used by the Trainer when given `mesh=`.

    `mesh` is a 1-D torch.distributed DeviceMesh whose dimension is "dp"
    (one process per device).  `collective_stats()` counts the all-reduces
    of each op ("classification", "regression", "descend", "ridge",
    "gather"), their bytes and their seconds: on the card the time between
    CUDA events recorded on the compute stream around each all-reduce (no
    synchronisation in the ops), on the CPU the host clock."""

    def __init__(self, mesh):
        self.group, self.rank, self.nd, self.device = dp_mesh(mesh)
        self.stats: Dict[str, Dict[str, float]] = {
            op: {"collectives": 0, "bytes": 0, "seconds": 0.0}
            for op in ("classification", "regression", "descend", "ridge", "gather")
        }
        self._events: List[Tuple[str, object, object]] = []  # timings not read yet
        # the group's first collective sets up its communicator (NCCL's
        # lazily): make it here, on every rank alike, outside the timed ops
        dist.all_reduce(torch.zeros(1, device=self.device), group=self.group)
        # the largest |total| (S_tot of a regression node, an entry of the
        # ridge's b) seen, in residual units: the sums are exact below 2^14
        self.max_abs_sum = 0.0

    # -- placement --------------------------------------------------------

    def shard(self, n: int) -> slice:
        """This rank's contiguous range of n sample rows."""
        return block(n, self.nd, self.rank)

    def _all_reduce(self, buf: Tensor, op: str) -> Tensor:
        st = self.stats[op]
        st["collectives"] += 1
        st["bytes"] += buf.numel() * buf.element_size()
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            dist.all_reduce(buf, group=self.group)
            st["seconds"] += time.perf_counter() - t0
            return buf
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        dist.all_reduce(buf, group=self.group)
        end.record()
        self._events.append((op, start, end))
        if len(self._events) >= 1024:
            self.collective_stats()
        return buf

    def collective_stats(self) -> Dict[str, Dict[str, float]]:
        """Per op: all-reduces, bytes and seconds so far.  On the card it
        waits for the pending all-reduces and reads their events."""
        if self._events:
            self._events[-1][2].synchronize()
            for op, start, end in self._events:
                self.stats[op]["seconds"] += start.elapsed_time(end) / 1e3
            self._events.clear()
        return self.stats

    def _gather_all(self, parts: List[Tuple[Tensor, int]], op: str = "gather") -> List[Tensor]:
        """Each (this rank's slab x, n) as the whole [n, ...] tensor, all in
        one all-reduce.  x is int32 or float32; floats travel as their
        int32 bits, which keeps every pattern (-0.0 and NaN too)."""
        bufs = []
        for x, n in parts:
            if x.dtype not in (torch.int32, torch.float32):
                raise TypeError(f"gather takes int32 or float32, not {x.dtype}")
            per = -(-n // self.nd)
            buf = torch.zeros((self.nd * per,) + tuple(x.shape[1:]), dtype=torch.int32,
                              device=self.device)
            buf[self.rank * per : self.rank * per + len(x)] = x.contiguous().view(torch.int32)
            bufs.append(buf)
        flat = self._all_reduce(torch.cat([b.reshape(-1) for b in bufs]), op)
        out, off = [], 0
        for (x, n), buf in zip(parts, bufs):
            whole = flat[off : off + buf.numel()].view(buf.shape)[:n]
            out.append(whole.view(x.dtype))
            off += buf.numel()
        return out

    def gather(self, x: Tensor, n: int) -> Tensor:
        """The whole [n, ...] tensor on every rank from each rank's slab."""
        return self._gather_all([(x, n)])[0]

    # -- split search -----------------------------------------------------

    def classification_split(
        self,
        vals_p: Tensor,  # [mp, F] int32 values of this rank's positive rows
        w_p: Tensor,  # [mp] f32 their weights
        vals_n: Tensor,  # [mn, F] negatives
        w_n: Tensor,
        n_p: int,  # the node's positives on all ranks
        n_n: int,
    ) -> Tuple[int, int, Tensor, Tensor, Tensor]:
        """(feature, threshold, entropy, the feature's [n_p] and [n_n] value
        columns) of the node's minimum-entropy split (sharded.py:79-152 of
        the JAX package)."""
        F = vals_p.shape[1]
        ones_p = torch.ones(len(vals_p), dtype=torch.bool, device=self.device)
        ones_n = torch.ones(len(vals_n), dtype=torch.bool, device=self.device)
        wp, cp = SP._hists(vals_p, w_p, ones_p)
        wn, cn = SP._hists(vals_n, w_n, ones_n)
        counts = torch.tensor([len(vals_p), len(vals_n)], dtype=torch.float32,
                              device=self.device)
        buf = self._all_reduce(
            torch.cat([h.reshape(-1) for h in (wp, cp, wn, cn)] + [counts]), "classification"
        )
        hp = buf[: 4 * F * SP.NBINS].view(4, F, SP.NBINS)
        f, th, e = SP.classification_split_from_hists(
            hp[0], hp[1], hp[2], hp[3], buf[-2], buf[-1]
        )
        f, th = int(f), int(th)
        col_p, col_n = self._gather_all(
            [(vals_p[:, f], n_p), (vals_n[:, f], n_n)], "classification"
        )
        return f, th, e, col_p, col_n

    def regression_split(
        self,
        vals_p: Tensor,  # [mp, F] int32 values of this rank's positive rows
        resid: Tensor,  # [mp, 2] f32 their cart-landmark residuals
        has_gt: Tensor,  # [mp] bool
        u: Tensor,  # [F] f32 percentiles
        vals_n: Tensor,  # [mn, F] negatives (for their column)
        n_p: int,
        n_n: int,
    ) -> Tuple[int, int, Tensor, Tensor, Tensor]:
        """(feature, threshold, metric, value columns) of the node's minimum
        residual-variance split (sharded.py:154-264 of the JAX package)."""
        F = vals_p.shape[1]
        ones = torch.ones(len(vals_p), dtype=torch.bool, device=self.device)
        _, cnt = SP._hists(vals_p, torch.zeros(len(vals_p), device=self.device), ones)
        pos_n = torch.tensor([len(vals_p)], dtype=torch.float32, device=self.device)
        buf = self._all_reduce(torch.cat([cnt.reshape(-1), pos_n]), "regression")
        pos_n = buf[-1]
        th = SP.percentile_thresholds(buf[:-1].view(F, SP.NBINS), pos_n, u)
        sums = SP.regression_sums(
            vals_p, SP.quantize_residual(resid), has_gt.to(torch.float32), th
        )
        sums = self._all_reduce(sums, "regression")
        self.max_abs_sum = max(self.max_abs_sum, float(sums[3 * F + 1 :].abs().max()))
        f, th, metric = SP.regression_decision(th, sums, pos_n)
        f, th = int(f), int(th)
        col_p, col_n = self._gather_all(
            [(vals_p[:, f], n_p), (vals_n[:, f], n_n)], "regression"
        )
        return f, th, metric, col_p, col_n

    # -- tree descent (update_scores / gen_lbf) ---------------------------

    def descend(
        self,
        chunk: Dict[str, Tensor],
        flat: Tensor,
        state: Dict[str, Tensor],  # this rank's rows
        n: int,
        **kw,
    ) -> Tuple[Tensor, Tensor]:
        """ops/cascade.carts_descend on the slab (no collective), then the
        whole (leaves [n, C], leaf scores [n, C]) gathered in one all-reduce
        (sharded.py:266-305 of the JAX package)."""
        leaves, b = C.carts_descend(chunk, flat, state, **kw)
        leaves, b = self._gather_all([(leaves, n), (b, n)], "descend")
        return leaves, b

    # -- LBF ridge --------------------------------------------------------

    def ridge_accumulate(self, leaves: np.ndarray, resid: np.ndarray, F: int):
        """The summed (A [F, F], b [F, 2L]) of every rank's slab rows
        (leaves, residuals on the 2^-10 grid), in one all-reduce
        (sharded.py:307-336 of the JAX package).  No pad rows exist, so
        no validity mask is needed."""
        A, b = RG.normal_equations(leaves, resid, F, self.device)
        buf = self._all_reduce(torch.cat([A, b], 1), "ridge")
        b = buf[:, F:]
        self.max_abs_sum = max(self.max_abs_sum, float(b.abs().max()) if b.numel() else 0.0)
        return buf[:, :F], b


def ridge_lbf_sharded(
    ops: ShardedOps,
    leaves: np.ndarray,  # [N, K] global leaf ids, the same on every rank
    residual: np.ndarray,  # [N, 2L]
    F: int,
    lam: Optional[float] = None,
) -> np.ndarray:
    """Mesh-sharded regression.ridge_lbf: each rank accumulates its rows,
    one all-reduce sums (A, b), every rank solves the same system.  Returns
    W [F, 2L] float64, equal on every rank and to ridge_lbf's on the same
    device."""
    n = len(leaves)
    if lam is None:
        lam = n / 2.0
    rows = ops.shard(n)
    A, b = ops.ridge_accumulate(leaves[rows], RG.quantize_residuals(residual[rows]), F)
    return RG._solve(A, b, lam)
