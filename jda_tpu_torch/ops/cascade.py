"""Batched cascade forward on a set of candidate windows.

PyTorch counterpart of the JAX package's ops/cascade.py.  A batch of N
windows traverses the cascade together (the reference evaluates one window
at a time, c/jda.c:360-414):

  * tree descent walks the visited path only: node = 2*node + 1 + (v > th),
    three steps for depth-4 carts, with the node parameters indexed per
    (window, cart);
  * the shape-indexed pixel-difference feature is two reads from a flat
    image buffer (flat_idx = base + y*stride + x);
  * early exit is a sticky `alive` mask; callers compact survivors;
  * the per-stage shape update adds the K weight rows one after another in
    float32 (exact mode), as the C library does.

Landmark selection is plain indexing (exact), where the JAX package uses a
one-hot matmul at HIGHEST precision.  Every float op keeps the JAX order, so
the results are bit-identical on the same inputs.  The exception is the
per-stage similarity transform of the C++ path (`stp`, off in both shipped
configs): its means, sums and 2x2 products may round differently from
XLA's, so results with it agree with the JAX package's within its own
tolerances (tests/test_st_detect.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor


def round_half_away(x: Tensor) -> Tensor:
    """C++ round(): half away from zero (data.cpp:48-51 uses std::round)."""
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5)).to(
        torch.int32
    )


def trunc_toward_zero(x: Tensor) -> Tensor:
    """C (int) cast (c/jda.c:378-381)."""
    return x.to(torch.int32)


def take_fill(flat_img: Tensor, idx: Tensor) -> Tensor:
    """flat_img[idx] as int32, and the int32 minimum where idx lies past
    the buffer's end.

    The half and quarter patches of a multi-scale model claim win x win
    pixels of a smaller pyramid level (c/jda.c:347-352), so near the bottom
    edge their reads run past the end of the stacked pyramid, where the C
    library reads whatever memory follows.  The JAX package's `jnp.take`
    yields the int32 minimum there and the pixel difference wraps in int32;
    this does the same, so that both packages agree on every window.
    """
    n = flat_img.shape[0]
    v = flat_img[idx.clamp(max=n - 1)].to(torch.int32)
    return torch.where(idx < n, v, torch.iinfo(torch.int32).min)


def st_calc_dev(shapes: Tensor, mean_shape: Tensor) -> Tensor:
    """Batched STParameter::Calc (data.cpp:64-114): [N, 2, 2] scale*rotation
    matrices mapping mean-shape-frame offsets into each window's current
    shape frame, in float32.  st_calc_dev(mean, mean) is exactly the
    identity, which the dense stage-0 filter relies on."""
    x1 = shapes[:, 0::2]
    y1 = shapes[:, 1::2]
    x2 = mean_shape[0::2].expand_as(x1)
    y2 = mean_shape[1::2].expand_as(y1)
    tx1 = x1 - x1.mean(1, keepdim=True)
    ty1 = y1 - y1.mean(1, keepdim=True)
    tx2 = x2 - x2.mean(1, keepdim=True)
    ty2 = y2 - y2.mean(1, keepdim=True)
    s1 = torch.sqrt((tx1 * tx1 + ty1 * ty1).sum(1))
    s2 = torch.sqrt((tx2 * tx2 + ty2 * ty2).sum(1))
    scale = s1 / s2
    tx1n, ty1n = tx1 / s1[:, None], ty1 / s1[:, None]
    tx2n, ty2n = tx2 / s2[:, None], ty2 / s2[:, None]
    num = (ty1n * tx2n - tx1n * ty2n).sum(1)
    den = (tx1n * tx2n + ty1n * ty2n).sum(1)
    norm = torch.sqrt(num * num + den * den)
    sin_t = num / norm
    cos_t = den / norm
    return torch.stack(
        [
            torch.stack([scale * cos_t, scale * -sin_t], dim=1),
            torch.stack([scale * sin_t, scale * cos_t], dim=1),
        ],
        dim=1,
    )


def init_state(
    n: int,
    mean_shape: Tensor,
    base: Tensor,
    stride: Tensor,
    pw: Tensor,
    ph: Tensor,
    valid: Tensor,
) -> Dict[str, Tensor]:
    """Fresh window state: shape = mean shape (shift_size=0 detection path,
    c/jda.c:361).  base/stride/pw/ph are [n, 3], one column per pyramid
    level."""
    dev = mean_shape.device
    L2 = mean_shape.shape[-1]
    return {
        "shape": mean_shape.to(torch.float32).expand(n, L2).clone(),
        "score": torch.zeros(n, dtype=torch.float32, device=dev),
        "alive": valid.to(torch.bool),
        "nvis": torch.zeros(n, dtype=torch.int32, device=dev),
        "base": base.to(torch.int32),
        "stride": stride.to(torch.int32),
        "pw": pw.to(torch.int32),
        "ph": ph.to(torch.int32),
    }


def carts_descend(
    chunk: Dict[str, Tensor],
    flat_img: Tensor,
    state: Dict[str, Tensor],
    *,
    depth: int,
    rounding: bool,
    single_scale: bool = False,
    stp: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Tree descent of all C carts of `chunk` for all N windows.

    Within a stage the trees are independent: the running score only gates
    whether the reference keeps evaluating (cascador.cpp:188-191), never
    which pixels a tree reads.  So all carts descend at once over an [N, C]
    frontier; the score chain stays sequential (score_chain).  `stp`
    [N, 2, 2] maps each feature offset into the window's current shape
    frame first (STParameter::Apply, data.cpp:41-42).

    Returns (leaves [N, C] int32, b [N, C] float32 leaf scores).
    """
    C, node_n = chunk["feat_th"].shape
    N = state["shape"].shape[0]
    shape_x = state["shape"][:, 0::2]  # [N, L]
    shape_y = state["shape"][:, 1::2]
    to_int = round_half_away if rounding else trunc_toward_zero
    cart = torch.arange(C, device=flat_img.device)[None, :]  # [1, C]

    def level(a: Tensor, node: Tensor) -> Tensor:
        # the [N, C] pyramid-level column of a [N, 3] geometry field
        if single_scale:
            return a[:, 0:1].expand(N, C)
        return a.gather(1, chunk["scale"][cart, node].to(torch.int64))

    node = torch.zeros((N, C), dtype=torch.int64, device=flat_img.device)
    for _ in range(depth - 1):
        base = level(state["base"], node).to(torch.int64)
        stride = level(state["stride"], node).to(torch.int64)
        pw = level(state["pw"], node)
        ph = level(state["ph"], node)

        def pixel(lmk_f: str, off_f: str) -> Tensor:
            lmk = chunk[lmk_f][cart, node].to(torch.int64)
            off = chunk[off_f][cart, node]  # [N, C, 2]
            px = shape_x.gather(1, lmk)
            py = shape_y.gather(1, lmk)
            ox, oy = off[..., 0], off[..., 1]
            if stp is not None:
                ox, oy = (
                    stp[:, 0, 0, None] * ox + stp[:, 0, 1, None] * oy,
                    stp[:, 1, 0, None] * ox + stp[:, 1, 1, None] * oy,
                )
            x = to_int((px + ox) * pw.to(torch.float32))
            y = to_int((py + oy) * ph.to(torch.float32))
            x = torch.minimum(torch.clamp(x, min=0), pw - 1)
            y = torch.minimum(torch.clamp(y, min=0), ph - 1)
            idx = base + y.to(torch.int64) * stride + x
            if single_scale:
                return flat_img[idx].to(torch.int32)
            return take_fill(flat_img, idx)

        v = pixel("lmk1", "off1") - pixel("lmk2", "off2")
        bit = v > chunk["feat_th"][cart, node]
        node = 2 * node + 1 + bit.to(torch.int64)
    leaves = node - node_n
    b = chunk["leaf_scores"][cart, leaves]
    return leaves.to(torch.int32), b


def score_chain(
    b: Tensor,  # [N, C] per-cart leaf score contributions
    chunk: Dict[str, Tensor],
    score: Tensor,  # [N]
    alive: Tensor,  # [N]
    nvis: Tensor,  # [N]
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sequential score/threshold chain in the reference op order
    (c/jda.c:395-399): score = (score + leaf - mean) / std while alive;
    nvis counts the visit; then reject if score < th."""
    mean, std, cth = chunk["mean"], chunk["std"], chunk["cart_th"]
    for k in range(b.shape[1]):
        s_new = (score + b[:, k] - mean[k]) / std[k]
        score = torch.where(alive, s_new, score)
        nvis = nvis + alive.to(torch.int32)
        alive = alive & (score >= cth[k])
    return score, alive, nvis


def run_cart_chunk(
    chunk: Dict[str, Tensor],
    flat_img: Tensor,
    state: Dict[str, Tensor],
    *,
    depth: int,
    rounding: bool,
    single_scale: bool = False,
    stp: Optional[Tensor] = None,
) -> Tuple[Dict[str, Tensor], Tensor]:
    """Run a contiguous run of carts (no regression at the end).

    chunk fields are stacked [C, ...]; returns (state, leaves [N, C] int32).
    """
    leaves, b = carts_descend(
        chunk,
        flat_img,
        state,
        depth=depth,
        rounding=rounding,
        single_scale=single_scale,
        stp=stp,
    )
    score, alive, nvis = score_chain(
        b, chunk, state["score"], state["alive"], state["nvis"]
    )
    out = dict(state)
    out["score"], out["alive"], out["nvis"] = score, alive, nvis
    return out, leaves


def apply_regression(
    W_t: Tensor,  # [K*leaf_n, 2L]
    leaves: Tensor,  # [N, K]
    state: Dict[str, Tensor],
    *,
    leaf_n: int,
    exact: bool = True,
    stp: Optional[Tensor] = None,  # [N, 2, 2] similarity (mean -> current)
) -> Dict[str, Tensor]:
    """Per-stage shape update from local binary features.

    exact=True replays the reference's arithmetic bit for bit: the K weight
    rows are added onto the shape one after another in float32
    (c/jda.c:403-411).  This matters because downstream feature coordinates
    are truncated to ints: a tree-reduction sum can differ by ~1 ulp and
    flip a truncation boundary.  exact=False sums with one one-hot matmul
    (~1e-7 relative difference).

    stp rotates the summed delta before the shape update (GenDeltaShape's
    stp_mc.Apply, btcart.cpp:407-424): the weight rows are summed from zero
    first, then rotated, then added to the shape.

    Only stage survivors receive the update (rejected windows stop moving).
    """
    n, K = leaves.shape
    L2 = W_t.shape[-1]
    Wk = W_t.reshape(K, leaf_n, L2)
    lv = leaves.to(torch.int64)
    if exact:
        delta = state["shape"] if stp is None else torch.zeros_like(state["shape"])
        for k in range(K):
            delta = delta + Wk[k][lv[:, k]]
    else:
        onehot = torch.nn.functional.one_hot(lv, leaf_n).to(W_t.dtype)
        delta = onehot.reshape(n, K * leaf_n) @ W_t
    if stp is not None:
        dx, dy = delta[:, 0::2], delta[:, 1::2]
        delta = torch.stack(
            [
                stp[:, 0, 0, None] * dx + stp[:, 0, 1, None] * dy,
                stp[:, 1, 0, None] * dx + stp[:, 1, 1, None] * dy,
            ],
            dim=2,
        ).reshape(n, L2)
    new_shape = delta if exact and stp is None else state["shape"] + delta
    out = dict(state)
    out["shape"] = torch.where(state["alive"][:, None], new_shape, state["shape"])
    return out


_STAGE_FIELDS = (
    "scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores",
    "cart_th", "mean", "std",
)


def stage_params(dev: Dict[str, Tensor], t: int) -> Dict[str, Tensor]:
    """Slice the SoA model to one stage's cart chunk (all K carts)."""
    return {k: dev[k][t] for k in _STAGE_FIELDS}


def cascade_full(
    dev: Dict[str, Tensor],
    flat_img: Tensor,
    state: Dict[str, Tensor],
    *,
    depth: int,
    rounding: bool,
    leaf_n: int,
    T: int,
    exact: bool = True,
    single_scale: bool = False,
    with_stp: bool = False,
) -> Dict[str, Tensor]:
    """All T stages on one batch, no compaction (reference-faithful
    scoring).

    with_stp reproduces Validate's per-stage similarity transform
    (cascador.cpp:180,196): recomputed from each window's current shape at
    stage entry, applied to feature offsets during descent and to the
    regression delta.  Off in both shipped configs.
    """
    for t in range(T):
        stp = st_calc_dev(state["shape"], dev["mean_shape"]) if with_stp else None
        state, leaves = run_cart_chunk(
            stage_params(dev, t),
            flat_img,
            state,
            depth=depth,
            rounding=rounding,
            single_scale=single_scale,
            stp=stp,
        )
        state = apply_regression(
            dev["W"][t], leaves, state, leaf_n=leaf_n, exact=exact, stp=stp
        )
    return state
