"""Fused detection pipeline for single-scale models.

PyTorch counterpart of the JAX package's `make_fused_fn` and
`make_fused_fn2`.  One call runs the whole cascade over a batch of images,

  1. the dense stage-0 filter over every scan scale (ops/dense0.py);
  2. survivor compaction, per group of scales;
  3. the stage-0 leaves, read back from the filter's packed words (s0_lbf)
     or re-descended on the survivors, and the stage-0 regression;
  4. stages 1..T-1, compacting after each stage but the last.

Without `groups` (make_fused_fn) every scale is one gather pass that also
compacts after the first STAGE_SPLIT carts of each stage (when K >
2*STAGE_SPLIT).  With `groups` (make_fused_fn2, group_scales) each group
of scales is compacted and run on its own: the canvas groups (window size
<= S) through the canvas tail (ops/mxu_tail.py), the gather group (win >=
GATHER_MIN) through the gather tail; both compact after each stage only.
Banded canvases (the C++ path's method-0 pyramids) give each scan grid a
canvas origin.

On a CUDA device the gather group's steps 3 and 4 (T >= 2) are one launch
of the survivor tail kernel (ops/tail.py), which counts the survivors at
the same compaction points and leaves the same lanes; everywhere else they
run the plain PyTorch tail of ops/cascade.py.

Compaction has dynamic sizes (torch.nonzero), so `counts` are the true
survivor counts and there are no lane budgets to overflow.  Every
per-window float sequence (score chain, exact sequential regression) is
the JAX package's, so results are bit-identical.  Lanes come out group by
group, each group's in ascending (image, window), as in both JAX
programs: per image they are in ascending window id, the order in which
the C++ path's NMS breaks ties.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from jda_tpu_torch import tracing
from jda_tpu_torch.ops import cascade as C
from jda_tpu_torch.ops import dense0 as D0
from jda_tpu_torch.ops import mxu_tail as MT
from jda_tpu_torch.ops import tail as TK

Tensor = torch.Tensor

# carts per leading chunk of stages >= 1: trained cascades front-load
# rejection within a stage too, so compacting after the first SPLIT carts
# roughly halves the lanes the remaining K - SPLIT carts pay for
STAGE_SPLIT = 64

GATHER_MIN = 257  # smallest win that stays on the gather tail


def compact(alive: Tensor) -> Tuple[Tensor, int]:
    """Indices (int64, ascending) of the alive lanes and their count."""
    with tracing.span("compact"):
        sel = torch.nonzero(alive).reshape(-1)
        return sel, int(sel.shape[0])


def takes_tail_kernel(S: Optional[int], T: int, device: torch.device) -> bool:
    """Whether a group's stages run as the survivor tail kernel
    (ops/tail.py): the gather group (S None) of a model with T >= 2 on a
    CUDA device.  Every other group takes the plain tail."""
    return S is None and T >= 2 and device.type == "cuda"


def unpack_lbf(words: Tensor, K: int) -> Tensor:
    """[N, lbf_words(K)] packed stage-0 leaf words -> [N, K] leaf indices
    (4 bits per cart, cart k in word k//8 at nibble k%8 — ops/dense0.py)."""
    rep = words.repeat_interleave(D0.LBF_PER_WORD, dim=1)[:, :K]
    sh = (torch.arange(K, device=words.device) % D0.LBF_PER_WORD) * D0.LBF_BITS
    return (rep >> sh[None, :].to(words.dtype)) & ((1 << D0.LBF_BITS) - 1)


def group_scales(
    meta: Sequence[Tuple[int, int, int, int]],
    buckets: Tuple[int, ...] = (32, 64, 128, 256),
) -> Tuple[dict, ...]:
    """Partition the scan ladder into canvas-bucket groups.

    meta is in enumeration order (win ascending, c/jda.c:331-332), so each
    group is a contiguous run of scales and a contiguous window-index
    slice.  Returns dicts {S (canvas size; None = gather tail), si0, si1
    (scale range), w0, w1 (flat window range)}.
    """
    offs = [0]
    for _, _, ny, nx in meta:
        offs.append(offs[-1] + ny * nx)
    groups = []
    si = 0
    for S in buckets:
        sj = si
        while sj < len(meta) and meta[sj][0] <= S:
            sj += 1
        if sj > si:
            groups.append({"S": S, "si0": si, "si1": sj, "w0": offs[si], "w1": offs[sj]})
            si = sj
    if si < len(meta):
        groups.append(
            {"S": None, "si0": si, "si1": len(meta), "w0": offs[si], "w1": offs[-1]}
        )
    return tuple(groups)


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
    groups: Optional[Sequence[dict]] = None,
    tail: Optional[TK.TailTables] = None,
) -> Dict[str, Tensor]:
    """Run the cascade over one batch.  `prepared` takes the dense filter's
    tables of this geometry (D0.prepare_image), which the caller keeps with
    its plan; `tail` the survivor tail kernel's tables of this model
    (TK.pack_tables), which the caller keeps (built here where the kernel
    runs without them).

    `groups` (group_scales) runs make_fused_fn2's grouped pass; None runs
    make_fused_fn's single gather pass.

    `origins` gives each scan grid a canvas origin (y0, x0) (banded scans):
    `xywin` and the tables are in canvas coordinates, and a window is
    valid where it fits its band's content rectangle.  `dims` may then be
    [B, S, 2], one (w, h) per band, band-local; [B, 2] dims apply to every
    band.  Returns

      sel        [m] flat window id (b*n + w) of each final lane
      score, shape, alive, nvis   per final lane
      counts     [c] survivor count at each compaction point, group by group
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
    split = groups is None and K > 2 * STAGE_SPLIT
    if groups is None:
        groups = ({"S": None, "w0": 0, "w1": n},)
    split_at = STAGE_SPLIT if split else 0
    # compaction points of a group after its stage-0 one
    n_points = TK.n_points(T, split_at)
    counts = []
    outs = []

    def bank_nvis(nvis_img, state, sel_global, mask):
        """Add masked lanes' post-dense visit increments to their own
        image's bank."""
        inc = torch.where(mask, state["nvis"] - state["dnvis"], 0)
        return nvis_img.index_add(0, sel_global // n, inc)

    def do_compact(state, sel_global, nvis_img, carried=None):
        lsel, cnt = compact(state["alive"])
        # lanes dropped here were rejected mid-tail: bank their post-dense
        # visit increments before they disappear (a canvas group's
        # canvases go with their lanes)
        nvis_img = bank_nvis(nvis_img, state, sel_global, ~state["alive"])
        state = {k: v[lsel] for k, v in state.items()}
        sel_global = sel_global[lsel]
        carried = None if carried is None else carried[lsel]
        counts.append(cnt)
        return state, sel_global, nvis_img, carried

    for g in groups:
        # -- 2. compaction of the group's stage-0 survivors ----------------------
        w0, w1, S = g["w0"], g["w1"], g["S"]
        ng = w1 - w0
        sel, count0 = compact(alive_ok[:, w0:w1].reshape(-1))
        counts.append(count0)
        b_idx = sel // ng
        w_idx = w0 + sel % ng
        sel_global = b_idx * n + w_idx
        if count0 and takes_tail_kernel(S, T, imgs.device):
            # -- 3-4. the gather group's tail in one kernel launch -------------
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
            outs.append((sel_global, state))
            continue
        wx, wy, ws = xywin[w_idx, 0], xywin[w_idx, 1], xywin[w_idx, 2]
        if S is None:
            state = C.init_state(
                count0,
                dev["mean_shape"],
                torch.stack([b_idx * (H * W) + wy.long() * W + wx.long()] * 3, dim=1),
                torch.full((count0, 3), W, dtype=torch.int32, device=imgs.device),
                torch.stack([ws] * 3, dim=1),
                torch.stack([ws] * 3, dim=1),
                torch.ones(count0, dtype=torch.bool, device=imgs.device),
            )

            def run_chunk(chunk, state):
                return C.run_cart_chunk(
                    chunk, flat_img, state, depth=depth, rounding=rounding,
                    single_scale=True,
                )

            def descend(chunk, state):
                return C.carts_descend(
                    chunk, flat_img, state, depth=depth, rounding=rounding,
                    single_scale=True,
                )

        else:
            L2 = dev["mean_shape"].shape[-1]
            state = {
                "shape": dev["mean_shape"].to(torch.float32).expand(count0, L2).clone(),
                "alive": torch.ones(count0, dtype=torch.bool, device=imgs.device),
                "pw": ws,
                "canvas": MT.canvas_rows(flat_img, b_idx, wx, wy, H, W, S),
            }

            def run_chunk(chunk, state):
                return MT.run_cart_chunk_canvas(
                    chunk, state["canvas"], state, depth=depth, rounding=rounding
                )

            def descend(chunk, state):
                return MT.descend_canvas(
                    chunk, state["canvas"], state["pw"], state["shape"],
                    depth=depth, rounding=rounding,
                )

        state["score"] = score_d.reshape(-1)[sel_global]
        state["nvis"] = nvis_d.reshape(-1)[sel_global]
        # the dense nvis per lane: the tail banks only increments beyond it
        state["dnvis"] = state["nvis"]

        if count0 == 0:  # nothing to run: the group's later counts are 0
            counts.extend([0] * n_points)
            outs.append((sel_global, state))
            continue

        # -- 3. stage-0 leaves and regression ----------------------------------
        with tracing.span("stage", t=0):
            if s0_lbf:
                leaves0 = unpack_lbf(dense[3].reshape(B * n, -1)[sel_global], K)
            else:
                leaves0, _ = descend(C.stage_params(dev, 0), state)
            state = C.apply_regression(dev["W"][0], leaves0, state, leaf_n=leaf_n)

        # -- 4. stages 1..T-1 ---------------------------------------------------
        for t in range(1, T):
            with tracing.span("stage", t=t):
                sp = C.stage_params(dev, t)
                if split:
                    state, leavesA = run_chunk(
                        {k: v[:STAGE_SPLIT] for k, v in sp.items()}, state
                    )
                    state, sel_global, nvis_img, leavesA = do_compact(
                        state, sel_global, nvis_img, leavesA
                    )
                    state, leavesB = run_chunk(
                        {k: v[STAGE_SPLIT:] for k, v in sp.items()}, state
                    )
                    leaves = torch.cat([leavesA, leavesB], dim=1)
                else:
                    state, leaves = run_chunk(sp, state)
                state = C.apply_regression(dev["W"][t], leaves, state, leaf_n=leaf_n)
                if t < T - 1:
                    state, sel_global, nvis_img, _ = do_compact(
                        state, sel_global, nvis_img
                    )
                    if not sel_global.numel():  # every lane rejected
                        counts.extend([0] * ((T - 1 - t) * split + T - 2 - t))
                        break

        # post-dense increments of every lane still resident after stage T-1
        nvis_img = bank_nvis(
            nvis_img, state, sel_global, torch.ones_like(state["alive"])
        )
        outs.append((sel_global, state))

    return {
        "sel": torch.cat([s for s, _ in outs]),
        "score": torch.cat([st["score"] for _, st in outs]),
        "shape": torch.cat([st["shape"] for _, st in outs]),
        "alive": torch.cat([st["alive"] for _, st in outs]),
        "nvis": torch.cat([st["nvis"] for _, st in outs]),
        "counts": torch.tensor(counts, dtype=torch.int32),
        "nvis_img": nvis_img,
        "total_nvis": nvis_img.sum(),
    }
