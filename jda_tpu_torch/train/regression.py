"""Global shape regression over Local Binary Features.

PyTorch counterpart of the JAX package's train/regression.py.  The
reference trains 2*landmark_n liblinear SVRs (L2R_L2LOSS_SVR_DUAL, C=1/n,
p=0; btcart.cpp:328-388) on a K-hot design matrix (one leaf per cart).
With p=0 that objective is L2-regularized least squares, so one
closed-form ridge solve serves all 2L targets:

    (X^T X + lam I) w = X^T y,   lam = 1/(2C) = n/2.

X^T X is the co-occurrence count matrix of leaf pairs, built by chunked
one-hot float32 products: counts and fixed-point residual sums are exact
in float32 in any order, but only without TF32, so a card with TF32
matrix products enabled is refused.  One Cholesky solve covers every
target column.  W is equal to the JAX package's within rounding, not bit
for bit: LAPACK and cuSOLVER factor in different orders.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from jda_tpu_torch.train.split import RESID_FRAC_BITS


def _check_no_tf32(device: torch.device) -> None:
    if device.type == "cuda" and (
        torch.backends.cuda.matmul.allow_tf32
        or torch.get_float32_matmul_precision() != "highest"
    ):
        raise RuntimeError(
            "ridge_lbf needs exact float32 products: TF32 matrix products are "
            "enabled (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision); turn them off"
        )


def quantize_residuals(residual: np.ndarray) -> np.ndarray:
    """float32 residuals on the fixed 2^-10 grid: the normal-equation sums
    are then exact in any order and partition."""
    q = np.float32(1 << RESID_FRAC_BITS)
    return np.round(residual.astype(np.float32) * q) / q


def normal_equations(
    leaves: np.ndarray,  # [n, K] global leaf indices
    residual: np.ndarray,  # [n, 2L] float32 on the residual grid
    F: int,
    device: torch.device,
    chunk: int = 8192,
):
    """(A = E^T E [F, F], b = E^T r [F, 2L]) float32 of the one-hot LBF
    rows E, accumulated in chunks of `chunk` rows."""
    _check_no_tf32(device)
    lv = torch.as_tensor(np.ascontiguousarray(leaves, np.int64), device=device)
    rs = torch.as_tensor(residual, device=device)
    A = torch.zeros((F, F), dtype=torch.float32, device=device)
    b = torch.zeros((F, rs.shape[1]), dtype=torch.float32, device=device)
    for s0 in range(0, len(lv), chunk):
        s1 = min(s0 + chunk, len(lv))
        E = torch.zeros((s1 - s0, F), dtype=torch.float32, device=device)
        E.scatter_(1, lv[s0:s1], 1.0)
        A += E.T @ E
        b += E.T @ rs[s0:s1]
    return A, b


def _solve(A: torch.Tensor, b: torch.Tensor, lam: float) -> np.ndarray:
    """W [F, 2L] float64 of (A + lam I) W = b by one Cholesky solve."""
    F = A.shape[0]
    A = A + torch.tensor(lam, dtype=torch.float32, device=A.device) * torch.eye(
        F, dtype=torch.float32, device=A.device
    )
    W = torch.cholesky_solve(b, torch.linalg.cholesky(A))
    return W.cpu().numpy().astype(np.float64)


def ridge_lbf(
    leaves: np.ndarray,  # [N, K] global leaf indices (k*leaf_n + leaf)
    residual: np.ndarray,  # [N, 2L]
    F: int,  # K * leaf_n
    lam: Optional[float] = None,
    chunk: int = 8192,
    device: Union[str, torch.device] = "cpu",
) -> np.ndarray:
    """Solve the LBF ridge regression on `device`; returns W [F, 2L]
    float64."""
    n = len(leaves)
    if lam is None:
        lam = n / 2.0  # liblinear C = 1/n  =>  lam = 1/(2C)
    A, b = normal_equations(
        leaves, quantize_residuals(residual), F, torch.device(device), chunk
    )
    return _solve(A, b, lam)
