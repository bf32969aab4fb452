"""Fused detection pipeline for single-scale models.

PyTorch counterpart of the JAX package's `make_fused_fn`, and of the gather
groups of its `make_fused_fn2` (banded canvases: the C++ path's method-0
pyramids, with a canvas origin per scan grid).  One call runs the whole
cascade over a batch of images,

  1. the dense stage-0 filter over every scan scale (ops/dense0.py);
  2. survivor compaction;
  3. the stage-0 leaves, read back from the filter's packed words (s0_lbf)
     or re-descended on the survivors, and the stage-0 regression;
  4. stages 1..T-1, compacting after the first STAGE_SPLIT carts of each
     stage (when K > 2*STAGE_SPLIT) and after each stage but the last.

Compaction has dynamic sizes (torch.nonzero), so `counts` are the true
survivor counts and there are no lane budgets to overflow.  Every
per-window float sequence (score chain, exact sequential regression) is
the JAX package's, so results are bit-identical.  The final lanes are in
ascending flat window id, as in both JAX programs under their default
single gather group: per image, the C++ path's NMS breaks ties in that
order.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import dense0 as D0

Tensor = torch.Tensor

# carts per leading chunk of stages >= 1: trained cascades front-load
# rejection within a stage too, so compacting after the first SPLIT carts
# roughly halves the lanes the remaining K - SPLIT carts pay for
STAGE_SPLIT = 64


def compact(alive: Tensor) -> Tuple[Tensor, int]:
    """Indices (int64, ascending) of the alive lanes and their count."""
    sel = torch.nonzero(alive).reshape(-1)
    return sel, int(sel.shape[0])


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
) -> Dict[str, Tensor]:
    """Run the cascade over one batch.  `prepared` takes the dense filter's
    tables of this geometry (D0.prepare_image), which the caller keeps with
    its plan.

    `origins` gives each scan grid a canvas origin (y0, x0) (banded scans,
    make_fused_fn2): `xywin` and the tables are in canvas coordinates, and
    a window is valid where it fits its band's content rectangle.  `dims`
    may then be [B, S, 2], one (w, h) per band, band-local; [B, 2] dims
    apply to every band.  Returns

      sel        [m] flat window id (b*n + w) of each final lane
      score, shape, alive, nvis   per final lane
      counts     [c] survivor count at each compaction point
      nvis_img   [B] exact per-image cart visits
      total_nvis scalar
    """
    B = imgs.shape[0]
    n = sum(ny * nx for _, _, ny, nx in meta)

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
    alive_flat = (alive_d & ok).reshape(-1)
    # per-image cart-visit bank (exact DetectionStatistic per image)
    nvis_img = torch.where(ok, nvis_d, 0).sum(1, dtype=torch.int32)

    # -- 2. compaction of the stage-0 survivors -------------------------------
    sel, count0 = compact(alive_flat)
    w_idx = sel % n
    base_o = (sel // n) * (H * W) + xywin[w_idx, 1].long() * W + xywin[w_idx, 0].long()
    win_s = xywin[w_idx, 2]
    state = C.init_state(
        count0,
        dev["mean_shape"],
        torch.stack([base_o] * 3, dim=1),
        torch.full((count0, 3), W, dtype=torch.int32, device=imgs.device),
        torch.stack([win_s] * 3, dim=1),
        torch.stack([win_s] * 3, dim=1),
        torch.ones(count0, dtype=torch.bool, device=imgs.device),
    )
    state["score"] = score_d.reshape(-1)[sel]
    state["nvis"] = nvis_d.reshape(-1)[sel]
    # the dense nvis per lane: the tail banks only increments beyond it
    state["dnvis"] = state["nvis"]

    flat_img = imgs.reshape(-1)
    K = dev["feat_th"].shape[1]

    # -- 3. stage-0 leaves and regression --------------------------------------
    if s0_lbf:
        leaves0 = unpack_lbf(dense[3].reshape(B * n, -1)[sel], K)
    else:
        leaves0, _ = C.carts_descend(
            C.stage_params(dev, 0), flat_img, state, depth=depth,
            rounding=rounding, single_scale=True,
        )
    state = C.apply_regression(dev["W"][0], leaves0, state, leaf_n=leaf_n)

    counts = [count0]
    sel_global = sel
    split = K > 2 * STAGE_SPLIT

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

    # -- 4. stages 1..T-1 -------------------------------------------------------
    for t in range(1, T):
        sp = C.stage_params(dev, t)
        if split:
            state, leavesA = C.run_cart_chunk(
                {k: v[:STAGE_SPLIT] for k, v in sp.items()}, flat_img, state,
                depth=depth, rounding=rounding, single_scale=True,
            )
            state, sel_global, nvis_img, leavesA = do_compact(
                state, sel_global, nvis_img, leavesA
            )
            state, leavesB = C.run_cart_chunk(
                {k: v[STAGE_SPLIT:] for k, v in sp.items()}, flat_img, state,
                depth=depth, rounding=rounding, single_scale=True,
            )
            leaves = torch.cat([leavesA, leavesB], dim=1)
        else:
            state, leaves = C.run_cart_chunk(
                sp, flat_img, state, depth=depth, rounding=rounding,
                single_scale=True,
            )
        state = C.apply_regression(dev["W"][t], leaves, state, leaf_n=leaf_n)
        if t < T - 1:
            state, sel_global, nvis_img, _ = do_compact(
                state, sel_global, nvis_img
            )

    # post-dense increments of every lane still resident after stage T-1
    nvis_img = bank_nvis(
        nvis_img, state, sel_global, torch.ones_like(state["alive"])
    )
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
