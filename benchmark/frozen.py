"""Frozen copies of everything that defines the benchmark's work.

The images, the scenes and the synthetic cascade are generated here, by
copies of the repository's generators as they stood when the benchmark was
defined, so that a later change to the program cannot move the yardstick:

  * `make_image` is bench_torch.make_image (bench.py's blocky texture);
  * `FACE27`, `_blur`, `_face` and `make_scene` are chip_smoke.py's planted
    VGA scenes;
  * `realistic_drop_profile` and `synthetic_model` are
    jda_tpu_torch/params.py's, returning plain numpy fields;
  * `read_model` reads a model file in the reference's "double" format
    (JoinCascador::SerializeTo), as the C library does.

benchmark/tests/test_frozen.py holds each against the original.  Nothing
here imports the program.
"""

from __future__ import annotations

import hashlib

import numpy as np

FIELDS = ("mean_shape", "scale", "lmk1", "lmk2", "off1", "off2", "feat_th",
          "leaf_scores", "cart_th", "mean", "std", "W")


def make_image(h, w, seed):
    """Blocky texture plus noise (bench.make_image)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h // 8 + 2, w // 8 + 2)).astype(np.float32)
    img = np.kron(base, np.ones((8, 8), np.float32))[:h, :w]
    noise = rng.normal(0, 12, (h, w))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


# 27-landmark face template in [0, 1] window coordinates (brows, eyes,
# nose, mouth, chin): the layout the flagship model was trained on
FACE27 = np.array([
    [0.22, 0.30], [0.30, 0.26], [0.38, 0.30], [0.62, 0.30], [0.70, 0.26],
    [0.78, 0.26], [0.25, 0.40], [0.31, 0.38], [0.35, 0.41], [0.65, 0.41],
    [0.69, 0.38], [0.75, 0.40], [0.50, 0.45], [0.44, 0.55], [0.50, 0.58],
    [0.56, 0.55], [0.50, 0.62], [0.35, 0.72], [0.42, 0.69], [0.50, 0.68],
    [0.58, 0.69], [0.65, 0.72], [0.50, 0.74], [0.42, 0.76], [0.58, 0.76],
    [0.38, 0.88], [0.62, 0.88],
])


def _blur(img, sigma):
    """Separable Gaussian blur (reflected borders), float64."""
    r = int(3 * sigma + 0.5)
    k = np.exp(-0.5 * (np.arange(-r, r + 1) / sigma) ** 2)
    k /= k.sum()
    out = np.pad(img, r, mode="reflect")
    out = np.apply_along_axis(np.convolve, 1, out, k, "valid")
    return np.apply_along_axis(np.convolve, 0, out, k, "valid")


def _face(rng, size, jitter=0.0):
    """A face patch as the flagship model's training scenes draw one: dark
    landmark blobs, a forehead band and cheek highlights on noise, band
    limited."""
    base, spread = int(rng.integers(85, 175)), int(rng.integers(15, 45))
    img = rng.integers(base - spread, base + spread, (size, size)).astype(np.float64)
    dark, r = int(rng.integers(10, 60)), max(1, size // 24)
    lm = np.clip(FACE27 + rng.normal(0, jitter, FACE27.shape), 0.04, 0.96) if jitter else FACE27
    for gx, gy in lm:
        x, y = int(gx * size), int(gy * size)
        img[max(y - r, 0) : y + r + 1, max(x - r, 0) : x + r + 1] = dark
    ys = int(FACE27[:6, 1].min() * size)
    img[max(ys - size // 6, 0) : ys, size // 4 : 3 * size // 4] += int(rng.integers(25, 75))
    bh, cy, ch = max(3, size // 16), int(FACE27[13, 1] * size), int(rng.integers(15, 50))
    img[cy : cy + bh, size // 8 : size // 4] += ch
    img[cy : cy + bh, 3 * size // 4 : 7 * size // 8] += ch
    img += rng.integers(-12, 13, (size, size))
    img = _blur(np.clip(img, 0, 255), max(0.6, 0.6 * size / 48))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_scene(h, w, seed, faces=3):
    """`make_image` with `faces` non-overlapping faces of 60-149 px planted
    in it.  Returns (image, [(x, y, size)] of the faces)."""
    img = make_image(h, w, seed)
    rng = np.random.default_rng(seed + 1000)
    boxes = []
    for _ in range(faces):
        s = int(rng.integers(60, 150))
        for _ in range(50):
            x, y = int(rng.integers(0, w - s)), int(rng.integers(0, h - s))
            if all(x + s <= bx or bx + bs <= x or y + s <= by or by + bs <= y
                   for bx, by, bs in boxes):
                break
        img[y : y + s, x : x + s] = _face(rng, s)
        boxes.append((x, y, s))
    return img, boxes


def realistic_drop_profile(T, K):
    """Per-cart conditional drop rates shaped like a trained cascade
    (params.realistic_drop_profile): stage 0 front-loads rejection, every
    later stage passes roughly a third of what reaches it."""
    prof = np.full(T * K, 5e-4)
    prof[:32] = 0.06
    prof[32:128] = 0.02
    prof[128 : min(K, T * K)] = 0.004
    for t in range(1, T):
        s = t * K
        prof[s : s + min(64, K)] = 0.01
        prof[s + 64 : (t + 1) * K] = 0.001
    return prof


def calibrate_thresholds(leaf_scores, drop_profile, seed):
    """The cart thresholds of `synthetic_model(drop_profile=)`: th_k at the
    drop_profile[k] quantile of the random score trajectories still alive
    at cart k, dead trajectories resampled onto live ones when the pool
    thins out.  [T, K] float64."""
    T, K, leaf_n = leaf_scores.shape
    M = 1 << 16
    sim = np.random.default_rng(seed + 1)
    leaf_flat = leaf_scores.reshape(T * K, leaf_n)
    s = np.zeros(M)
    alive = np.ones(M, bool)
    th = np.full(T * K, -1e9)
    for k in range(T * K):
        s = s + leaf_flat[k, sim.integers(0, leaf_n, M)]
        n_live = int(alive.sum())
        if n_live and n_live < M // 64:
            dead = np.flatnonzero(~alive)
            src = np.flatnonzero(alive)
            s[dead] = s[src[sim.integers(0, n_live, len(dead))]]
            alive[:] = True
            n_live = M
        live = s[alive]
        if n_live >= 256 and drop_profile[k] > 0:
            th[k] = np.quantile(live, drop_profile[k])
            alive &= s >= th[k]
    return th.reshape(T, K)


def synthetic_model(T, K, landmark_n, tree_depth, seed, cart_th=None):
    """A random single-scale cascade with the same numbers as
    params.synthetic_model(T, K, landmark_n, tree_depth, seed,
    drop_profile=realistic_drop_profile(T, K)), as a dict of numpy fields
    (FIELDS) plus its sizes.  `cart_th`, where given, is the calibrated
    [T, K] threshold table of that call (calibrate_thresholds), which
    stands in for the slow calibration."""
    rng = np.random.default_rng(seed)
    node_n = (1 << (tree_depth - 1)) - 1
    leaf_n = node_n + 1
    L2 = 2 * landmark_n
    ms = np.stack(
        [rng.uniform(0.15, 0.85, landmark_n), rng.uniform(0.15, 0.85, landmark_n)],
        axis=1,
    ).reshape(-1)

    def unit_disk(shape):
        pts = rng.uniform(-1.0, 1.0, shape + (2,))
        bad = (pts**2).sum(-1) > 1.0
        while bad.any():
            pts[bad] = rng.uniform(-1.0, 1.0, (int(bad.sum()), 2))
            bad = (pts**2).sum(-1) > 1.0
        return pts

    radius = 0.3
    m = dict(
        T=T, K=K, landmark_n=landmark_n, tree_depth=tree_depth,
        mean_shape=ms,
        scale=np.zeros((T, K, node_n), np.int32),
        lmk1=rng.integers(0, landmark_n, (T, K, node_n)).astype(np.int32),
        lmk2=rng.integers(0, landmark_n, (T, K, node_n)).astype(np.int32),
        off1=unit_disk((T, K, node_n)) * radius,
        off2=unit_disk((T, K, node_n)) * radius,
        feat_th=rng.integers(-80, 81, (T, K, node_n)).astype(np.int32),
        leaf_scores=rng.normal(0.0, 0.3, (T, K, leaf_n)),
        mean=np.zeros((T, K)),
        std=np.ones((T, K)),
        W=rng.normal(0.0, 1e-4, (T, K * leaf_n, L2)),
    )
    if cart_th is None:
        cart_th = calibrate_thresholds(
            m["leaf_scores"], realistic_drop_profile(T, K), seed
        )
    m["cart_th"] = np.asarray(cart_th, np.float64).reshape(T, K)
    return m


def sha256_file(path):
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def read_model(path):
    """A model file in the reference's "double" format
    (JoinCascador::SerializeTo: header of 7 int32, mean shape, per stage K
    carts of node records, leaf scores, threshold, mean and std, then the
    stage's weight matrix; a trailing int32), as a dict of numpy fields
    (FIELDS) plus its sizes."""
    raw = open(path, "rb").read()
    pos = 0

    def take(dtype, count):
        nonlocal pos
        dt = np.dtype(dtype)
        n = dt.itemsize * count
        if pos + n > len(raw):
            raise ValueError(f"{path}: truncated model file")
        out = np.frombuffer(raw, dtype=dt, count=count, offset=pos)
        pos += n
        return out

    _, T, K, L, depth, _, _ = (int(v) for v in take("<i4", 7))
    node_n = (1 << (depth - 1)) - 1
    leaf_n = node_n + 1
    node = np.dtype([("scale", "<i4"), ("lmk1", "<i4"), ("lmk2", "<i4"),
                     ("off", "<f8", (4,)), ("th", "<i4")])
    cart = np.dtype([("nodes", node, (node_n,)), ("leaf", "<f8", (leaf_n,)),
                     ("th", "<f8"), ("mean", "<f8"), ("std", "<f8")])
    m = dict(T=T, K=K, landmark_n=L, tree_depth=depth,
             mean_shape=take("<f8", 2 * L).copy())
    parts = {k: [] for k in FIELDS[1:]}
    for _ in range(T):
        c = take(cart, K)
        parts["scale"].append(c["nodes"]["scale"])
        parts["lmk1"].append(c["nodes"]["lmk1"])
        parts["lmk2"].append(c["nodes"]["lmk2"])
        parts["off1"].append(c["nodes"]["off"][..., 0:2])
        parts["off2"].append(c["nodes"]["off"][..., 2:4])
        parts["feat_th"].append(c["nodes"]["th"])
        parts["leaf_scores"].append(c["leaf"])
        parts["cart_th"].append(c["th"])
        parts["mean"].append(c["mean"])
        parts["std"].append(c["std"])
        parts["W"].append(take("<f8", K * leaf_n * 2 * L).reshape(K * leaf_n, 2 * L))
    take("<i4", 1)
    if pos != len(raw):
        raise ValueError(f"{path}: {len(raw) - pos} bytes past the model")
    for k, v in parts.items():
        dtype = np.int32 if k in ("scale", "lmk1", "lmk2", "feat_th") else np.float64
        m[k] = np.ascontiguousarray(np.stack(v), dtype)
    return m
