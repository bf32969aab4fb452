"""Split search: the training inner loop.

PyTorch counterpart of the JAX package's train/split.py.  The reference
scans 511-bin weighted histograms per candidate feature
(Cart::SplitNodeWithClassification, cart.cpp:176-252) and per-feature
percentile thresholds for regression (SplitNodeWithRegression,
cart.cpp:288-350).  Here both are whole-tensor programs:

  * classification: one scatter-add (`index_add_` over f*511 + bin) builds
    all F x 511 weighted histograms, a cumulative sum turns them into every
    (feature, threshold) split, and a masked reduction picks the
    minimum-entropy pair;
  * regression: each feature's random-percentile threshold is read from
    the count histogram's cumulative sum, and sums over each side give the
    size-weighted residual-variance objective.

Ties go to the first feature and the first threshold (argmin and the
first bin whose cumulative count reaches k), as the reference's scan
order; a split must be strictly better than the parent.

Determinism, kept step for step from the JAX package: boosting weights
arrive quantized to multiples of 2^-23 (DataSet.update_weights) and
residuals are quantized to 2^-10 here, so every sum feeding a decision is
an exact fixed-point sum, whatever the order of the card's atomics.  The
decision metrics are truncated by 12 mantissa bits (_quantize_metric)
before the argmin, which absorbs an ulp of difference between compiled
programs.  The entropy's logarithms are taken in float64 and rounded to
float32: the correctly rounded float32 log, the same on the card and on
the CPU (each platform's own float32 log may differ by an ulp).
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

NBINS = 511  # feature values live in [-255, 255] (cart.cpp:194-199)

# residual fixed-point grid: 2^-10 keeps sums of up to ~16k quanta-bounded
# residuals (|r| <= ~0.5 after shape init) exactly representable in f32
RESID_FRAC_BITS = 10

_METRIC_DROP_BITS = 12  # mantissa bits truncated before argmin


def _f32(x: float, like: Tensor) -> Tensor:
    """A float32 0-d tensor on `like`'s device.  Dividing by it is IEEE
    division on the card too (division by a host scalar is not)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def quantize_residual(r: Tensor) -> Tensor:
    """Round to the fixed residual grid (round half to even, as np.round)."""
    q = _f32(float(1 << RESID_FRAC_BITS), r)
    return torch.round(r.to(torch.float32) * q) / q


def _quantize_metric(x: Tensor) -> Tensor:
    """Truncate _METRIC_DROP_BITS low mantissa bits (monotone, sign-safe),
    so that sub-ulp differences between programs cannot flip an argmin.
    Non-finite values pass unchanged (masked-off lanes use inf)."""
    x = x.to(torch.float32).contiguous()
    mask = ~((1 << _METRIC_DROP_BITS) - 1)
    out = (x.view(torch.int32) & mask).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


def _log(x: Tensor) -> Tensor:
    return torch.log(x.to(torch.float64)).to(torch.float32)


def _entropy(p: Tensor) -> Tensor:
    """calcEntropy (cart.cpp:166-171): 0 at the degenerate ends."""
    one = _f32(1.0, p)
    safe = p.clamp(1e-12, 1.0 - 1e-12)
    h = -(safe * _log(safe) + (one - safe) * _log(one - safe)) / _log(_f32(2.0, p))
    eps = _f32(1e-9, p)
    degenerate = (p.abs() < eps) | ((one - p).abs() < eps)
    return torch.where(degenerate, torch.zeros_like(h), h)


def _hists(vals: Tensor, w: Tensor, valid: Tensor) -> Tuple[Tensor, Tensor]:
    """[F, 511] weight and count histograms of a [M, F] value matrix: the
    weight histogram sums w (callers zero it on invalid rows), the count
    histogram counts valid rows."""
    M, F = vals.shape
    bins = (vals.to(torch.int64) + 255).clamp(0, NBINS - 1)
    ids = (bins + torch.arange(F, device=vals.device) * NBINS).reshape(-1)
    wh = torch.zeros(F * NBINS, dtype=torch.float32, device=vals.device)
    wh.index_add_(0, ids, w.to(torch.float32)[:, None].expand(M, F).reshape(-1))
    ch = torch.bincount(
        ids[valid[:, None].expand(M, F).reshape(-1)], minlength=F * NBINS
    )
    return wh.view(F, NBINS), ch.view(F, NBINS).to(torch.float32)


def classification_split_from_hists(
    wp: Tensor,  # [F, 511] summed positive weights per bin
    cp: Tensor,  # [F, 511] positive counts per bin
    wn: Tensor,
    cn: Tensor,
    pos_n: Tensor,  # 0-d f32
    neg_n: Tensor,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Decision half of the classification split."""
    wp_tot = wp.sum(1, keepdim=True)  # [F, 1]
    wn_tot = wn.sum(1, keepdim=True)
    w_tot = wp_tot + wn_tot

    wp_l = wp.cumsum(1)  # inclusive: th = bin - 255
    wn_l = wn.cumsum(1)
    cp_l = cp.cumsum(1)
    cn_l = cn.cumsum(1)
    wp_r = wp_tot - wp_l
    wn_r = wn_tot - wn_l
    w_l = wp_l + wn_l
    w_r = wp_r + wn_r

    one = _f32(1.0, wp)
    lo, hi = _f32(0.1, wp), _f32(0.9, wp)
    tiny = _f32(1e-30, wp)

    # child fraction constraints (cart.cpp:225-228); an empty side passes
    # vacuously (0/0 is NaN in the reference and NaN fails both comparisons)
    def ratio_ok(cnt, total):
        r = cnt / torch.maximum(total, one)
        return (total == 0) | ((r >= lo) & (r <= hi))

    ok = ratio_ok(cp_l, pos_n) & ratio_ok(cn_l, neg_n)

    e = (w_l / w_tot) * _entropy(wp_l / torch.maximum(w_l, tiny)) + (
        w_r / w_tot
    ) * _entropy(wp_r / torch.maximum(w_r, tiny))
    e = _quantize_metric(torch.where(ok, e, torch.full_like(e, float("inf"))))

    parent = _quantize_metric(_entropy(wp_tot[:, 0] / w_tot[:, 0]))  # [F]
    best_e = e.amin(1)
    best_th = e.argmin(1).to(torch.int32) - 255
    improved = best_e < parent  # strict (cart.cpp:233)
    es = torch.where(improved, best_e, parent)
    ths = torch.where(improved, best_th, torch.full_like(best_th, -256))

    f_idx = es.argmin().to(torch.int32)
    return f_idx, ths[f_idx.long()], es[f_idx.long()]


def classification_split(
    vals_pos: Tensor,  # [Mp, F] int32
    w_pos: Tensor,  # [Mp] f32 (0 on invalid rows)
    valid_pos: Tensor,  # [Mp] bool
    vals_neg: Tensor,  # [Mn, F] int32
    w_neg: Tensor,  # [Mn] f32
    valid_neg: Tensor,  # [Mn] bool
) -> Tuple[Tensor, Tensor, Tensor]:
    """Minimum weighted-entropy (feature, threshold) pair.

    Returns (feature_idx int32, threshold int32, entropy f32), 0-d tensors;
    threshold -256 sends every sample right (cart.cpp:186-187).
    """
    wp, cp = _hists(vals_pos, w_pos, valid_pos)
    wn, cn = _hists(vals_neg, w_neg, valid_neg)
    pos_n = valid_pos.sum().to(torch.float32)
    neg_n = valid_neg.sum().to(torch.float32)
    return classification_split_from_hists(wp, cp, wn, cn, pos_n, neg_n)


def regression_split(
    vals_pos: Tensor,  # [Mp, F] int32
    residual: Tensor,  # [Mp, 2] f32 (cart-landmark residual, mean frame)
    has_gt: Tensor,  # [Mp] bool
    valid_pos: Tensor,  # [Mp] bool
    u: Tensor,  # [F] f32 random percentiles in [0.1, 0.9)
) -> Tuple[Tensor, Tensor, Tensor]:
    """Minimum size-weighted residual-variance split (cart.cpp:288-350).

    Thresholds are each feature's value at a random percentile of the
    sorted positives; variance counts only samples with a gt shape.
    Returns (feature_idx, threshold, metric), 0-d tensors.

    The reference objective n_l*var_l + n_r*var_r equals
    sum(r^2) - (S_l^2/n_l + S_r^2/n_r) with S the per-side residual sums;
    the first term does not depend on the feature, so the argmin reads the
    exact fixed-point sums (S_l, n_l) alone.
    """
    pos_n = valid_pos.sum()
    _, cnt = _hists(vals_pos, torch.zeros_like(valid_pos, dtype=torch.float32), valid_pos)
    th = percentile_thresholds(cnt, pos_n.to(torch.float32), u)
    gtv = (has_gt & valid_pos).to(torch.float32)  # [Mp]
    sums = regression_sums(vals_pos, quantize_residual(residual), gtv, th)
    return regression_decision(th, sums, pos_n)


def percentile_thresholds(cnt: Tensor, pos_n: Tensor, u: Tensor) -> Tensor:
    """[F] int32 thresholds: each feature's k-th order statistic, k =
    trunc(pos_n * u), from its [F, 511] count histogram.  Values are ints
    in [-255, 255], so sorted_vals[k] is the first bin whose cumulative
    count reaches k + 1."""
    k = (pos_n * u).to(torch.int32)  # trunc
    cum = cnt.cumsum(1)  # [F, 511]
    th = (cum >= (k + 1)[:, None].to(torch.float32)).to(torch.uint8).argmax(1)
    return th.to(torch.int32) - 255


def regression_sums(vals: Tensor, residual_q: Tensor, gtv: Tensor, th: Tensor) -> Tensor:
    """The objective's sufficient statistics over rows `vals`, packed as
    one float32 vector [nl (F), S_l x (F), S_l y (F), n_tot, S_tot x,
    S_tot y]: left-side counts and residual sums per feature at threshold
    th, and the totals, over the rows with gtv = 1.  Residuals on the
    2^-10 grid make every entry an exact sum, so partial vectors of any
    partition of the rows add up to the whole one."""
    left = (vals <= th[None, :]).to(torch.float32) * gtv[:, None]
    parts = [left.sum(0)]
    parts += [(left * residual_q[:, d : d + 1]).sum(0) for d in range(2)]
    parts.append(gtv.sum()[None])
    parts += [(gtv * residual_q[:, d]).sum()[None] for d in range(2)]
    return torch.cat(parts)


def regression_decision(th: Tensor, sums: Tensor, pos_n: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(feature, threshold, metric) from the thresholds and the summed
    statistics of regression_sums; no positives sends every sample right
    (feature 0, threshold -256)."""
    F = th.shape[0]
    nl = sums[:F]
    metric = regression_metric_from_sums(
        (sums[F : 2 * F], sums[3 * F + 1]),
        (sums[2 * F : 3 * F], sums[3 * F + 2]),
        nl=nl,
        nr=sums[3 * F] - nl,
    )
    f_idx = metric.argmin()
    has = pos_n > 0
    out_f = torch.where(has, f_idx, torch.zeros_like(f_idx)).to(torch.int32)
    out_th = torch.where(has, th[f_idx], torch.full_like(th[f_idx], -256))
    return out_f, out_th, metric[f_idx]


def regression_metric_from_sums(sums_x, sums_y, *, nl, nr):
    """Decision half of the regression split from per-side residual sums.

    sums_* = (S_l [F], S_tot scalar) per coordinate.  Returns the
    (quantized) metric to argmin: -(S_l^2/n_l + S_r^2/n_r) summed over
    coordinates, the reference's size-weighted variance objective minus
    its feature-independent constant (see regression_split).
    """
    one = _f32(1.0, nl)
    safe_l = torch.maximum(nl, one)
    safe_r = torch.maximum(nr, one)
    zero = torch.zeros_like(nl)
    obj = zero
    for S_l, S_tot in (sums_x, sums_y):
        S_r = S_tot - S_l
        obj = obj + torch.where(nl > 0, S_l * S_l / safe_l, zero)
        obj = obj + torch.where(nr > 0, S_r * S_r / safe_r, zero)
    return _quantize_metric(-obj)


def leaf_scores(
    leaf_pos: Tensor,  # [Mp] int64 leaf index per positive
    w_pos: Tensor,  # [Mp] (0 on invalid lanes)
    leaf_neg: Tensor,
    w_neg: Tensor,
    *,
    leaf_n: int,
    esp: float = 2.2e-16,
) -> Tensor:
    """RealBoost leaf scores 0.5*(log(esp+Σw+) − log(esp+Σw−))
    (cart.cpp:63-88)."""
    wp = torch.zeros(leaf_n, dtype=w_pos.dtype, device=w_pos.device)
    wn = torch.zeros(leaf_n, dtype=w_neg.dtype, device=w_neg.device)
    wp = wp.index_add_(0, leaf_pos.long(), w_pos) + esp
    wn = wn.index_add_(0, leaf_neg.long(), w_neg) + esp
    return 0.5 * (torch.log(wp) - torch.log(wn))
