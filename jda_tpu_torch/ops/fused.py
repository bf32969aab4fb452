"""Fused detection pipeline for single-scale models.

PyTorch counterpart of the JAX package's `make_fused_fn`.  One call runs
the whole cascade over a batch of images, every scan scale in one gather
pass:

  1. the dense stage-0 filter over every scan scale (ops/dense0.py);
  2. compaction of the stage-0 survivors;
  3. the stage-0 leaves, read back from the filter's packed words (s0_lbf)
     or re-descended on the survivors, and the stage-0 regression;
  4. stages 1..T-1, compacting after each stage but the last, and after
     the first STAGE_SPLIT carts of each stage when K > 2*STAGE_SPLIT.

Banded canvases (the C++ path's method-0 pyramids) give each scan grid a
canvas origin.

On a CUDA device steps 3 and 4 (T >= 2) are one launch of the survivor
tail kernel (ops/tail.py), which counts the survivors at the same
compaction points and leaves the same lanes; everywhere else they run the
plain PyTorch tail of ops/cascade.py.

The JAX package's canvas tail (make_fused_fn2) is a TPU layout choice that
gives the same answers; the port has none.

Compaction has dynamic sizes (torch.nonzero), so `counts` are the true
survivor counts and there are no lane budgets to overflow.  Every
per-window float sequence (score chain, exact sequential regression) is
the JAX package's, so results are bit-identical.  Lanes come out in
ascending (image, window): per image they are in ascending window id, the
order in which the C++ path's NMS breaks ties.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from jda_tpu_torch import tracing
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import dense0 as D0
from jda_tpu_torch.ops import tail as TK

Tensor = torch.Tensor

# carts per leading chunk of stages >= 1: trained cascades front-load
# rejection within a stage too, so compacting after the first SPLIT carts
# roughly halves the lanes the remaining K - SPLIT carts pay for
STAGE_SPLIT = 64


def compact(alive: Tensor) -> Tuple[Tensor, int]:
    """Indices (int64, ascending) of the alive lanes and their count."""
    with tracing.span("compact"):
        sel = torch.nonzero(alive).reshape(-1)
        return sel, int(sel.shape[0])


def takes_tail_kernel(T: int, device: torch.device) -> bool:
    """Whether the stages run as the survivor tail kernel (ops/tail.py): a
    model with T >= 2 on a CUDA device.  Everywhere else the plain tail
    runs."""
    return T >= 2 and device.type == "cuda"


def unpack_lbf(words: Tensor, K: int) -> Tensor:
    """[N, lbf_words(K)] packed stage-0 leaf words -> [N, K] leaf indices
    (4 bits per cart, cart k in word k//8 at nibble k%8 — ops/dense0.py)."""
    rep = words.repeat_interleave(D0.LBF_PER_WORD, dim=1)[:, :K]
    sh = (torch.arange(K, device=words.device) % D0.LBF_PER_WORD) * D0.LBF_BITS
    return (rep >> sh[None, :].to(words.dtype)) & ((1 << D0.LBF_BITS) - 1)


def run_fused(
    dev: Dict[str, Tensor],
    imgs: Tensor,  # [B, H, W] uint8
    dims: Tensor,  # [B, 2] int32 (img_w, img_h) per image
    tabs: Sequence[Tuple[Tensor, Tensor]],  # (tabi, tabf) per scan scale
    xywin: Tensor,  # [n, 3] int32 window (x, y, win) in enumeration order
    *,
    meta: Sequence[Tuple[int, int, int, int]],  # (win, step, ny, nx) per scale
    depth: int,
    leaf_n: int,
    T: int,
    H: int,
    W: int,
    rounding: bool = False,
    s0_lbf: bool = True,
    prepared: Optional[D0.ImageTables] = None,
    origins: Optional[Sequence[Tuple[int, int]]] = None,
    tail: Optional[TK.TailTables] = None,
) -> Dict[str, Tensor]:
    """Run the cascade over one batch.  `prepared` takes the dense filter's
    tables of this geometry (D0.prepare_image), which the caller keeps with
    its plan; `tail` the survivor tail kernel's tables of this model
    (TK.pack_tables), which the caller keeps (built here where the kernel
    runs without them).

    `origins` gives each scan grid a canvas origin (y0, x0) (banded scans):
    `xywin` and the tables are in canvas coordinates, and a window is
    valid where it fits its band's content rectangle.  `dims` may then be
    [B, S, 2], one (w, h) per band, band-local; [B, 2] dims apply to every
    band.  Returns

      sel        [m] flat window id (b*n + w) of each final lane
      score, shape, alive, nvis   per final lane
      counts     [1 + TK.n_points] survivor count at each compaction point
      nvis_img   [B] exact per-image cart visits
      total_nvis scalar
    """
    B = imgs.shape[0]
    n = sum(ny * nx for _, _, ny, nx in meta)
    K = dev["feat_th"].shape[1]

    # -- 1. dense stage-0 over all scales ------------------------------------
    dense = D0.stage0_filter_all_scales(
        imgs, tabs, meta=meta, depth=depth, emit_lbf=s0_lbf, prepared=prepared
    )
    score_d, alive_d, nvis_d = dense[:3]

    # per-image validity on the canonical grid: the window must fit inside
    # the image's own dims (its band's content, in band-local coordinates)
    x = xywin[:, 0][None, :]
    y = xywin[:, 1][None, :]
    win = xywin[:, 2][None, :]
    wl, hl = dims[:, 0:1], dims[:, 1:2]
    if origins is not None or dims.dim() == 3:
        sidx = torch.repeat_interleave(
            torch.arange(len(meta), device=imgs.device),
            torch.tensor([ny * nx for _, _, ny, nx in meta], device=imgs.device),
        )
        if origins is not None:
            org = torch.tensor(origins, dtype=torch.int32, device=imgs.device)
            x = x - org[sidx, 1][None, :]
            y = y - org[sidx, 0][None, :]
        if dims.dim() == 3:
            wl, hl = dims[:, sidx, 0], dims[:, sidx, 1]
    ok = (x <= wl - win) & (y <= hl - win)
    alive_ok = alive_d & ok
    # per-image cart-visit bank (exact DetectionStatistic per image)
    nvis_img = torch.where(ok, nvis_d, 0).sum(1, dtype=torch.int32)

    flat_img = imgs.reshape(-1)
    split = K > 2 * STAGE_SPLIT
    split_at = STAGE_SPLIT if split else 0
    # compaction points after the stage-0 one
    n_points = TK.n_points(T, split_at)
    counts = []

    def bank_nvis(nvis_img, state, sel_global, mask):
        """Add masked lanes' post-dense visit increments to their own
        image's bank."""
        inc = torch.where(mask, state["nvis"] - state["dnvis"], 0)
        return nvis_img.index_add(0, sel_global // n, inc)

    def do_compact(state, sel_global, nvis_img, carried=None):
        lsel, cnt = compact(state["alive"])
        # lanes dropped here were rejected mid-tail: bank their post-dense
        # visit increments before they disappear
        nvis_img = bank_nvis(nvis_img, state, sel_global, ~state["alive"])
        state = {k: v[lsel] for k, v in state.items()}
        sel_global = sel_global[lsel]
        carried = None if carried is None else carried[lsel]
        counts.append(cnt)
        return state, sel_global, nvis_img, carried

    def result(sel_global, state, nvis_img):
        return {
            "sel": sel_global,
            "score": state["score"],
            "shape": state["shape"],
            "alive": state["alive"],
            "nvis": state["nvis"],
            "counts": torch.tensor(counts, dtype=torch.int32),
            "nvis_img": nvis_img,
            "total_nvis": nvis_img.sum(),
        }

    # -- 2. compaction of the stage-0 survivors ------------------------------
    sel_global, count0 = compact(alive_ok.reshape(-1))
    counts.append(count0)
    if count0 and takes_tail_kernel(T, imgs.device):
        # -- 3-4. the tail in one kernel launch --------------------------------
        if tail is None:
            tail = TK.pack_tables(dev, depth)
        state, cnt = TK.walk(
            tail, imgs, xywin, sel_global, score_d, nvis_d,
            dense[3] if s0_lbf else None, nvis_img,
            rounding=rounding, split=split_at,
        )
        reach = state.pop("reach")
        if n_points:  # the lanes resident after the last compaction point
            keep, _ = compact(reach == n_points)
            counts.extend(cnt[1:].tolist())
            state = {k: v[keep] for k, v in state.items()}
            sel_global = sel_global[keep]
        return result(sel_global, state, nvis_img)

    b_idx, w_idx = sel_global // n, sel_global % n
    wx, wy, ws = xywin[w_idx, 0], xywin[w_idx, 1], xywin[w_idx, 2]
    state = C.init_state(
        count0,
        dev["mean_shape"],
        torch.stack([b_idx * (H * W) + wy.long() * W + wx.long()] * 3, dim=1),
        torch.full((count0, 3), W, dtype=torch.int32, device=imgs.device),
        torch.stack([ws] * 3, dim=1),
        torch.stack([ws] * 3, dim=1),
        torch.ones(count0, dtype=torch.bool, device=imgs.device),
    )
    state["score"] = score_d.reshape(-1)[sel_global]
    state["nvis"] = nvis_d.reshape(-1)[sel_global]
    # the dense nvis per lane: the tail banks only increments beyond it
    state["dnvis"] = state["nvis"]

    if count0 == 0:  # nothing to run: the later counts are 0
        counts.extend([0] * n_points)
        return result(sel_global, state, nvis_img)

    def run_chunk(chunk, state):
        return C.run_cart_chunk(
            chunk, flat_img, state, depth=depth, rounding=rounding, single_scale=True
        )

    # -- 3. stage-0 leaves and regression --------------------------------------
    with tracing.span("stage", t=0):
        if s0_lbf:
            leaves0 = unpack_lbf(dense[3].reshape(B * n, -1)[sel_global], K)
        else:
            leaves0, _ = C.carts_descend(
                C.stage_params(dev, 0), flat_img, state, depth=depth,
                rounding=rounding, single_scale=True,
            )
        state = C.apply_regression(dev["W"][0], leaves0, state, leaf_n=leaf_n)

    # -- 4. stages 1..T-1 -------------------------------------------------------
    for t in range(1, T):
        with tracing.span("stage", t=t):
            sp = C.stage_params(dev, t)
            if split:
                state, leavesA = run_chunk({k: v[:STAGE_SPLIT] for k, v in sp.items()}, state)
                state, sel_global, nvis_img, leavesA = do_compact(
                    state, sel_global, nvis_img, leavesA
                )
                state, leavesB = run_chunk({k: v[STAGE_SPLIT:] for k, v in sp.items()}, state)
                leaves = torch.cat([leavesA, leavesB], dim=1)
            else:
                state, leaves = run_chunk(sp, state)
            state = C.apply_regression(dev["W"][t], leaves, state, leaf_n=leaf_n)
            if t < T - 1:
                state, sel_global, nvis_img, _ = do_compact(state, sel_global, nvis_img)
                if not sel_global.numel():  # every lane rejected
                    counts.extend([0] * ((T - 1 - t) * split + T - 2 - t))
                    break

    # post-dense increments of every lane still resident after stage T-1
    nvis_img = bank_nvis(nvis_img, state, sel_global, torch.ones_like(state["alive"]))
    return result(sel_global, state, nvis_img)
