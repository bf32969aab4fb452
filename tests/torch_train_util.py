"""Helpers shared by the training parity tests (tests/test_torch_train*.py,
test_torch_mining.py, test_torch_cli.py): the same config, corpus and seed
through `jda_tpu` and `jda_tpu_torch` (on the CPU), and the comparisons."""

import dataclasses

import numpy as np
import pytest
import torch

import jda_tpu_torch.config as PC

# every model field but W is bit-equal between the packages
EXACT_FIELDS = (
    "scale", "lmk1", "lmk2", "off1", "off2", "feat_th", "leaf_scores",
    "cart_th", "mean", "std", "mean_shape",
)

# W is a float32 Cholesky solve (LAPACK in both packages on the CPU,
# cuSOLVER on the card, each factoring in its own order): held within
# 1e-5 of its largest entry, ~100 float32 ulps of the solve's relative error
# at the condition numbers of these normal equations (n/2 on the diagonal)
W_REL_TOL = 1e-5

# W of a stage trained on shapes that an earlier stage's W moved: those
# shapes agree only within rounding, and the residuals are rounded to
# 2^-10 (train/split.RESID_FRAC_BITS), so a residual can land one quantum
# apart, which moves W by ~1e-3 of its largest entry
W_LATER_REL_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The training tests run JAX and PyTorch side by side in each of the
    test runner's workers: one PyTorch thread per worker keeps them from
    oversubscribing the cores (the thread count is restored after the
    module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(c):
    """The port's Config with the fields of a jda_tpu Config."""
    return PC.Config(**dataclasses.asdict(c))


def w_close(wa: np.ndarray, wb: np.ndarray, rel: float = W_REL_TOL) -> bool:
    return float(np.abs(wa - wb).max()) <= rel * max(float(np.abs(wa).max()), 1e-30)


def model_diffs(a, b, later_from=None):
    """Names of the fields (W by tolerance, the cursor exactly) that
    differ between two models.  Stages from `later_from` on were trained on
    shapes moved by an earlier stage's W (W_LATER_REL_TOL)."""
    bad = [f for f in EXACT_FIELDS if not np.array_equal(getattr(a, f), getattr(b, f))]
    if (a.stage_idx, a.cart_idx) != (b.stage_idx, b.cart_idx):
        bad.append("cursor")
    for t in range(a.T):
        later = later_from is not None and t >= later_from
        if not w_close(a.W[t], b.W[t], W_LATER_REL_TOL if later else W_REL_TOL):
            bad.append(f"W[{t}] (max diff {np.abs(a.W[t] - b.W[t]).max():.3g})")
    return bad


def split_share(a, b) -> float:
    """Share of internal nodes with the same (landmarks, offsets,
    threshold) in two models."""
    same = (
        (a.feat_th == b.feat_th)
        & (a.lmk1 == b.lmk1)
        & (a.lmk2 == b.lmk2)
        & (a.off1 == b.off1).all(-1)
        & (a.off2 == b.off2).all(-1)
    )
    return float(same.mean())


# windows per mining batch in the CPU tests (the trainers' default is
# 2,048): the screens are most of the port's CPU time, and the packages
# must be held alike at any batch size
MINING_BATCH = 512


def train_both(c, rows, gts, bgs, mining_max_batches, setup=None):
    """The same synthetic corpus and seed through both trainers, the port
    on the CPU; `setup(trainer)` runs on each before train()."""
    from jda_tpu.train.boost import Trainer as JaxTrainer
    from jda_tpu_torch.train.boost import Trainer

    out = []
    for tr in (JaxTrainer(c), Trainer(port_config(c), device="cpu")):
        tr.mining_max_batches = mining_max_batches
        tr.mining_batch = MINING_BATCH
        tr.set_synthetic_data(rows, gts, bgs)
        if setup is not None:
            setup(tr)
        tr.train()
        out.append(tr)
    return out
