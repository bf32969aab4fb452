"""The stage-0 walk as the CUDA kernels of jda_tpu_torch do it, in plain
PyTorch: from the prepared tables (`ops/dense0.prepare_image`), the visited
path only, resumable at any cart.  tests/test_torch_dense0.py holds it
against the plain filter and emulates the kernels' two phases on it;
tests/test_torch_cuda.py holds the kernels against it.  Imports no JAX.
"""

import torch

from jda_tpu_torch.ops import dense0 as D0


def window_index(t):
    """(scale index, origin offset (iy*W + ix)*step) of every window of the
    ladder, int64 [n] each, in enumeration order."""
    dev = t.nodes.device
    sid, base = [], []
    for s, (_, step, ny, nx) in enumerate(t.meta):
        local = torch.arange(ny * nx, device=dev)
        sid.append(torch.full_like(local, s))
        base.append(((local // nx) * t.W + local % nx) * step)
    return torch.cat(sid), torch.cat(base)


def cart_leaves(img, t, k0, k1):
    """Leaf index int32 [B, n, k1 - k0] that carts [k0, k1) pick on every
    window of the ladder, descended as the kernels descend: the visited path
    only, pixels at the flat offsets of `t.nodes` from the window's origin.
    A leaf depends on the pixels alone, not on the score."""
    B = img.shape[0]
    node_n = (1 << (t.depth - 1)) - 1
    sid, base = window_index(t)
    flat = img.reshape(B, -1).to(torch.int32)
    sid, base = sid[None, :], base[None, :]
    out = []
    for k in range(k0, k1):
        node = torch.zeros((B, t.n), dtype=torch.int64, device=img.device)
        for _ in range(t.depth - 1):
            e = t.nodes[sid, k, node]  # [B, n, 4]
            v = flat.gather(1, base + e[..., 0]) - flat.gather(1, base + e[..., 1])
            node = 2 * node + 1 + (v > e[..., 2])
        out.append((node - node_n).to(torch.int32))
    return torch.stack(out, dim=-1)


def walk_reference(img, t, *, start=0, stop=None, state=None, emit_lbf=False):
    """Plain PyTorch walk of carts [start, stop) over every window of the
    ladder of the uint8 images [B, H, W], from the kernels' tables `t`: flat
    (score, alive, nvis) [B, n] and, with emit_lbf, the leaf words
    [B, n, lbf_words(K)] (of every window, whether alive or not).  `state`
    is such a tuple to resume from (default: score 0, alive, no visit, words
    0), so a walk split at any cart equals the whole one: that is what the
    kernels' two phases rely on.  The arithmetic is
    `scale_filter_reference`'s."""
    B = img.shape[0]
    K = t.tabf.shape[0]
    leaf_n = 1 << (t.depth - 1)
    stop = K if stop is None else min(stop, K)
    if state is None:
        state = (
            torch.zeros((B, t.n), dtype=torch.float32, device=img.device),
            torch.ones((B, t.n), dtype=torch.bool, device=img.device),
            torch.zeros((B, t.n), dtype=torch.int32, device=img.device),
        )
        if emit_lbf:
            state += (torch.zeros((B, t.n, D0.lbf_words(K)), dtype=torch.int32,
                                  device=img.device),)
    score, alive, nvis = state[:3]
    words = state[3].clone() if emit_lbf else None
    for k in range(start, stop):
        leaf = cart_leaves(img, t, k, k + 1)[..., 0]
        b = t.tabf[k, :leaf_n][leaf.to(torch.int64)]
        s_new = (score + b - t.tabf[k, leaf_n]) / t.tabf[k, leaf_n + 1]
        score = torch.where(alive, s_new, score)
        nvis = nvis + alive.to(torch.int32)
        alive = alive & (score >= t.tabf[k, leaf_n + 2])
        if emit_lbf:
            words[..., k // D0.LBF_PER_WORD] |= leaf << (
                D0.LBF_BITS * (k % D0.LBF_PER_WORD))
    return (score, alive, nvis) + ((words,) if emit_lbf else ())
