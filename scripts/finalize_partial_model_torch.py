"""Turn a mid-training model snapshot into a deployable cascade (the
port's counterpart of scripts/finalize_partial_model.py).

A snapshot taken mid-stage carries the training cursor (stage_idx,
cart_idx) and zero-initialized parameters for every cart past it.  Those
zeros are NOT inert at detection time (cart_th = 0 rejects any window
whose running score is negative), so this tool rewrites every untrained
cart as an exact pass-through (leaf scores 0, mean 0, std 1, threshold
-inf) — the same trick the trainer uses when the hard-negative supply is
exhausted (jda_tpu_torch/train/boost.py) — and advances the cursor to
"complete".

One difference from that script: a stage interrupted after some of its
carts has no stage-end regression yet (W == 0), and a cursor that marks it
complete is refused by save_model and load_model in both packages (the JAX
script fails on every mid-stage snapshot).  Such a model keeps the cursor
of its last trained cart: it detects with every trained cart (the detector
reads no cursor), its W of that stage moves no shape, and a resume
continues the stage and runs its regression.

Usage: python scripts/finalize_partial_model_torch.py in.model out.model
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from jda_tpu_torch.params import load_model, save_model  # noqa: E402


def finalize(src: str, dst: str) -> None:
    m = load_model(src)
    t0, k0 = m.stage_idx, m.cart_idx
    n_inert = 0
    for t in range(m.T):
        for k in range(m.K):
            trained = (t < t0) or (t == t0 and k <= k0)
            if trained:
                continue
            m.leaf_scores[t, k] = 0.0
            m.mean[t, k] = 0.0
            m.std[t, k] = 1.0
            m.cart_th[t, k] = -np.inf
            n_inert += 1
    # untrained stages also have W == 0 -> zero delta shape: harmless
    interrupted = t0 < m.T and np.any(m.leaf_scores[t0]) and not np.any(m.W[t0])
    if not interrupted:
        m.stage_idx, m.cart_idx = m.T, -1
    save_model(m, dst, dtype="double")
    print(
        f"{src} (cursor stage {t0} cart {k0}) -> {dst}: "
        f"{m.T * m.K - n_inert} trained carts, {n_inert} pass-through"
        + (f"; stage {t0} has no regression yet, cursor kept" if interrupted else "")
    )


if __name__ == "__main__":
    finalize(sys.argv[1], sys.argv[2])
