"""Canvas survivor tail: each surviving window's pixels, read once.

PyTorch counterpart of the JAX package's ops/mxu_tail.py.  Each surviving
window's pixels are copied once into a per-lane canvas [N, S, S] (int8,
pixel - 128, as in the JAX package), and every later pixel read of the
cascade indexes that canvas.  Lanes are grouped by window-size bucket S
(ops/fused.group_scales), so a lane pays S^2 bytes for its canvas.

The JAX package reads the canvas through one-hot int8 matmuls, the
TPU's way round its gather wall.  Here a read is plain indexing,
canvas[n, yq, xq]: the canvas flattened to one buffer is a batch of
images of one S x S plane per lane, and the descent is
`cascade.carts_descend`'s single-scale walk over it.  So the coordinate
arithmetic is carts_descend's (float32 multiply, truncation toward zero
or rounding half away from zero, clamp to the lane's true patch width)
and the results are bit-identical to the gather tail: the pixel
difference cancels the -128 shift.

The canvas is built one way, by row spans (canvas_rows).  It gives the
true pixel at every in-bounds position (row, col) < (win, win) of a lane,
the last image's bottom-right corner included; positions past the window
are padding, which no read reaches.  The JAX package's two builds
(JDA_TPU_CANVAS = "gather" or "rows") differ only where its row slices
clamp at that corner, so here both values build the same canvases.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from jda_tpu_torch.ops import cascade as C

Tensor = torch.Tensor


def _signed(pix: Tensor) -> Tensor:
    """Pixels (uint8 or int32, 0..255) as int8 pixel - 128."""
    return (pix.to(torch.int32) - 128).to(torch.int8)


def canvas_rows(
    flat_imgs: Tensor,  # [B*H*W] flat image batch (uint8 or int32)
    b_idx: Tensor,  # [N]
    x: Tensor,  # [N]
    y: Tensor,  # [N]
    H: int,
    W: int,
    S: int,
) -> Tensor:
    """Each lane's window pixels as an [N, S, S] int8 canvas (pixel - 128)
    by row spans; a window smaller than S fills the top-left corner.
    Each canvas row is S contiguous pixels: the flat batch, padded by S
    zeros, is viewed as its overlapping spans of S (`unfold`, no copy),
    and the N*S row starts index that view, so the index holds N*S
    elements, not N*S^2.  Every row of a window starts inside the buffer
    and its span ends at most S past it, inside the padding, so no span
    is clamped or shifted; only rows past the window (padding) are
    clamped to the last span."""
    L = flat_imgs.shape[0]
    spans = torch.cat([flat_imgs, flat_imgs.new_zeros(S)]).unfold(0, S, 1)
    rows = torch.arange(S, device=flat_imgs.device) * W
    base = b_idx.long() * (H * W) + y.long() * W + x.long()  # window origins
    starts = (base[:, None] + rows).reshape(-1).clamp_(max=L)
    return _signed(spans[starts]).view(-1, S, S)


def compact_canvas(canvas: Tensor, lselc: Tensor) -> Tensor:
    """canvas[lselc]: the canvases of the lanes kept by a compaction."""
    return canvas[lselc]


def descend_canvas(
    chunk: Dict[str, Tensor],  # stacked cart params [C, ...]
    canvas: Tensor,  # [N, S, S] int8 (pixel - 128)
    pw: Tensor,  # [N] int32 true patch width per lane (<= S)
    shapes: Tensor,  # [N, 2L] float32
    *,
    depth: int,
    rounding: bool,
    cart_block: int = 135,
) -> Tuple[Tensor, Tensor]:
    """Tree descent of C carts over N canvas lanes: the canvas twin of
    cascade.carts_descend (single-scale).  Returns (leaves [N, C] int32,
    b [N, C] float32 leaf scores).  cart_block bounds the [N, CB]
    temporaries of one pass."""
    N, S = canvas.shape[0], canvas.shape[-1]
    lane = torch.arange(N, device=canvas.device)[:, None]
    pw = pw.to(torch.int32)[:, None]
    # lane n's plane starts at n*S*S of the flat canvas, rows S apart
    geom = {
        "shape": shapes,
        "base": lane * (S * S),
        "stride": torch.full_like(lane, S),
        "pw": pw,
        "ph": pw,
    }
    flat = canvas.reshape(-1)
    parts = [
        C.carts_descend(
            {k: v[c0 : c0 + cart_block] for k, v in chunk.items()},
            flat,
            geom,
            depth=depth,
            rounding=rounding,
            single_scale=True,
        )
        for c0 in range(0, chunk["feat_th"].shape[0], cart_block)
    ]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts], 1), torch.cat([p[1] for p in parts], 1)


def run_cart_chunk_canvas(
    chunk: Dict[str, Tensor],
    canvas: Tensor,
    state: Dict[str, Tensor],  # shape, score, alive, nvis and pw [N]
    *,
    depth: int,
    rounding: bool,
) -> Tuple[Dict[str, Tensor], Tensor]:
    """Canvas twin of cascade.run_cart_chunk: the descent, then the exact
    sequential score and threshold chain (c/jda.c:395-399)."""
    leaves, b = descend_canvas(
        chunk, canvas, state["pw"], state["shape"], depth=depth,
        rounding=rounding,
    )
    score, alive, nvis = C.score_chain(
        b, chunk, state["score"], state["alive"], state["nvis"]
    )
    out = dict(state)
    out["score"], out["alive"], out["nvis"] = score, alive, nvis
    return out, leaves
