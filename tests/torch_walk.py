"""The walks of jda_tpu_torch's CUDA kernels in plain PyTorch.

The stage-0 walk: from the prepared tables (`ops/dense0.prepare_image`),
the visited path only, resumable at any cart.  tests/test_torch_dense0.py
holds it against the plain filter and emulates the kernels' two phases on
it; tests/test_torch_cuda.py holds the kernels against it.

The survivor tail kernel's multi-scale walk (`level_walk_reference`): from
its tables (`ops/tail.pack_tables`), every window through every stage with
no compaction, each node reading its level; tests/test_torch_tail.py holds
it against `Detector._run_batch`.  Imports no JAX.
"""

import torch

from jda_tpu_torch.ops import cascade as C
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


def level_pixel(pyr, idx):
    """pyr[idx] as an int64 holding the kernel's unsigned 32-bit value: the
    pixel, or 2**31 (the int32 minimum's bits) at or past the end."""
    inside = idx < pyr.shape[0]
    v = pyr[idx.clamp(max=pyr.shape[0] - 1)].to(torch.int64)
    return torch.where(inside, v, 2**31)


def level_walk_reference(tabs, pyr, xywin, base, strides, *, rounding):
    """The tail kernel's multi-scale walk (csrc/tail.cu with `levels`) in
    plain PyTorch, from its tables `tabs`: every window of one image's
    ladder (`xywin` [n, 3]) walks stages 0..T-1 with no compaction, stage
    0's chain from score 0 like every later stage, the chain sticky at the
    first reject, each stage's exact regression on the windows still alive.
    A node of level l (the fourth int of its `nodes_i` entry) reads both
    its points from the stacked pyramid `pyr` [F] uint8 at
    base[w, l] + y * strides[l] + x; at or past F the value is the int32
    minimum, and the difference is taken modulo 2**32, as the kernel's
    unsigned arithmetic takes it.  Returns per window `score`, `alive`,
    `nvis` and `shape`."""
    n = xywin.shape[0]
    T, K, depth, L2 = tabs.T, tabs.K, tabs.depth, tabs.L2
    node_n = (1 << (depth - 1)) - 1
    leaf_n = node_n + 1
    to_int = C.round_half_away if rounding else C.trunc_toward_zero
    rows = torch.arange(n)
    win = xywin[:, 2]
    winf = win.to(torch.float32)
    stride = torch.tensor(strides, dtype=torch.int64)
    base = base.to(torch.int64)
    shape = tabs.mean_shape.expand(n, L2).clone()
    score = torch.zeros(n, dtype=torch.float32)
    alive = torch.ones(n, dtype=torch.bool)
    nvis = torch.zeros(n, dtype=torch.int32)

    def coord(lmk, off, c):
        v = to_int((shape[rows, 2 * lmk + c] + off) * winf)
        return torch.minimum(v.clamp(min=0), win - 1).to(torch.int64)

    for t in range(T):
        leaves = []
        for k in range(K):
            node = torch.zeros(n, dtype=torch.int64)
            for _ in range(depth - 1):
                e = tabs.nodes_i[t, k][node].to(torch.int64)  # [n, 4]
                o = tabs.nodes_f[t, k][node]
                lvl = e[:, 3]
                b, st = base[rows, lvl], stride[lvl]
                p1 = level_pixel(pyr, b + coord(e[:, 0], o[:, 1], 1) * st
                                 + coord(e[:, 0], o[:, 0], 0))
                p2 = level_pixel(pyr, b + coord(e[:, 1], o[:, 3], 1) * st
                                 + coord(e[:, 1], o[:, 2], 0))
                d = (p1 - p2) & 0xFFFFFFFF
                v = torch.where(d >= 2**31, d - 2**32, d)
                node = 2 * node + 1 + (v > e[:, 2]).to(torch.int64)
            leaf = node - node_n
            leaves.append(leaf)
            cf = tabs.cartf[t, k]
            s_new = (score + cf[leaf] - cf[leaf_n]) / cf[leaf_n + 1]
            score = torch.where(alive, s_new, score)
            nvis = nvis + alive.to(torch.int32)
            alive = alive & (score >= cf[leaf_n + 2])
        rows_w = tabs.W[t].reshape(K, leaf_n, L2)
        moved = shape
        for k in range(K):
            moved = moved + rows_w[k][leaves[k]]
        shape = torch.where(alive[:, None], moved, shape)
    return {"score": score, "alive": alive, "nvis": nvis, "shape": shape}
