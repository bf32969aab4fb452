"""The cascade of a multi-scale configuration (`model.kind: "module"`).

luoyetx/JDA trains with `multi_scale: true` (config.template.json's
`image_size` block) into a model whose every split node reads its two
points from one of three levels: the image, the image scaled by 1/sqrt(2),
the image scaled by 1/2 (c/jda.c:340-354, 450-457).  The trained weights
are not public, so this is a frozen copy of jda_tpu_torch/params.py's
`synthetic_model(T, K, landmark_n, tree_depth, seed, multi_scale=True,
drop_profile=realistic_drop_profile(T, K))`: random weights from the seed,
each node's level drawn uniformly from o/h/q right after the mean shape,
so every later array differs from frozen.synthetic_model's.  The thresholds
are calibrated from the seed with the drop profile, or read from the
configuration's `cart_th_file`, which stands in for the 3-4 s calibration.
Nothing here imports the program.
"""

from __future__ import annotations

import os

import numpy as np

from benchmark.frozen import calibrate_thresholds, realistic_drop_profile


def synthetic_model_ms(T, K, landmark_n, tree_depth, seed, cart_th=None):
    """The multi-scale cascade's numpy fields (frozen.FIELDS) plus its
    sizes; `cart_th`, where given, is the calibrated [T, K] table."""
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
        scale=rng.integers(0, 3, (T, K, node_n)).astype(np.int32),
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
        cart_th = calibrate_thresholds(m["leaf_scores"], realistic_drop_profile(T, K), seed)
    m["cart_th"] = np.asarray(cart_th, np.float64).reshape(T, K)
    return m


def fields(config, root):
    """The configuration's arrays: its sizes, `model.seed` and, where
    given, the thresholds stored at `model.cart_th_file`."""
    m = config["model"]
    th = np.load(os.path.join(root, m["cart_th_file"])) if m.get("cart_th_file") else None
    return synthetic_model_ms(config["T"], config["K"], config["landmark_n"],
                              config["tree_depth"], m["seed"], cart_th=th)
