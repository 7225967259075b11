"""Per-assay benchmark metrics as torch tensor code in float64 on an
explicit device (counterpart of proteingym_tpu/metrics/core.py).

Five metrics, with the reference's evaluation semantics
(performance_DMS_benchmarks.py:11-78, 212-226):

  - Spearman   — scipy.stats.spearmanr (Pearson on average ranks)
  - AUC        — sklearn.roc_auc_score through the Mann-Whitney rank identity
  - MCC        — sklearn.matthews_corrcoef after binarising the scores at
                 their median (x >= median -> 1)
  - NDCG       — the reference's top-10% NDCG with min-max gains and
                 ordinal (stable argsort) ranks
  - Top_recall — overlap of the top-10-percentile sets

Every function works on the last axis and takes a boolean ``valid`` mask
of the same shape; leading axes are a batch (the JAX package's ``vmap``),
so assays or model columns padded to a common length with valid=False
are evaluated in one call. Edge values follow the JAX package: NaN for a
single-class AUC, 0.0 for a degenerate MCC but NaN for an all-NaN label
column, 0.0 for an NDCG with no positive gain in the top k. Counts are
float64, so their products cannot overflow.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from proteingym_tpu_torch.constants import METRICS
from proteingym_tpu_torch.devices import resolve_device

_BIG = 1e30  # float64 sentinel pushing invalid slots to the end of sorts
F64 = torch.float64


def _f64(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=device)


def _valid_like(valid, x: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return torch.as_tensor(valid, dtype=torch.bool, device=x.device)


def _masked(x, valid, fill):
    return torch.where(valid, x, torch.full_like(x, fill))


def _count(mask) -> torch.Tensor:
    return mask.sum(dim=-1).to(F64)


def _take(sorted_x, idx) -> torch.Tensor:
    """sorted_x[..., idx] for one index per leading row, clamped as JAX
    clamps an out-of-range gather."""
    idx = idx.clamp(0, sorted_x.shape[-1] - 1)
    return torch.gather(sorted_x, -1, idx.unsqueeze(-1)).squeeze(-1)


def average_rank(x, valid=None, device=None) -> torch.Tensor:
    """1-based average (midrank) ranks, as scipy.stats.rankdata: by one sort
    and the searchsorted identity (left + right + 1) / 2. Invalid slots get
    large ranks; callers mask them out. A valid NaN ranks above every
    number, tied with the other NaNs, as it does in an unpadded call in
    numpy or JAX (torch's searchsorted has no order for NaN): NaN takes
    the sentinel and invalid slots +inf, so padding cannot outrank it."""
    x = _f64(x, device)
    valid = _valid_like(valid, x)
    xm = _masked(torch.where(torch.isnan(x), _BIG, x), valid, torch.inf)
    sx = torch.sort(xm, dim=-1).values
    left = torch.searchsorted(sx, xm, side="left")
    right = torch.searchsorted(sx, xm, side="right")
    return (left + right + 1).to(F64) / 2.0


def _masked_mean(x, valid):
    n = valid.sum(dim=-1, keepdim=True)
    return torch.where(valid, x, 0.0).sum(dim=-1, keepdim=True) / n.clamp(min=1)


def _pearson(x, y, valid):
    dx = torch.where(valid, x - _masked_mean(x, valid), 0.0)
    dy = torch.where(valid, y - _masked_mean(y, valid), 0.0)
    num = (dx * dy).sum(dim=-1)
    den = torch.sqrt((dx * dx).sum(dim=-1) * (dy * dy).sum(dim=-1))
    return torch.where(den > 0, num / den, torch.nan)


def spearman(y_true, y_score, valid=None, device=None) -> torch.Tensor:
    """Spearman rho with average-rank ties (== scipy.stats.spearmanr)."""
    y_true = _f64(y_true, device)
    y_score = _f64(y_score, y_true.device)
    valid = _valid_like(valid, y_true)
    return _pearson(average_rank(y_true, valid), average_rank(y_score, valid), valid)


def auc(y_bin, y_score, valid=None, device=None) -> torch.Tensor:
    """ROC AUC by the Mann-Whitney identity (== sklearn.roc_auc_score):
    (positive rank sum - n_pos (n_pos + 1) / 2) / (n_pos n_neg), average
    ranks for tied scores; NaN when only one class is present."""
    y_bin = _f64(y_bin, device)
    y_score = _f64(y_score, y_bin.device)
    valid = _valid_like(valid, y_bin)
    pos = valid & (y_bin > 0.5)
    neg = valid & (y_bin <= 0.5)
    n_pos, n_neg = _count(pos), _count(neg)
    r = average_rank(y_score, valid)
    rank_sum_pos = torch.where(pos, r, 0.0).sum(dim=-1)
    val = (rank_sum_pos - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg).clamp(min=1)
    return torch.where((n_pos > 0) & (n_neg > 0), val, torch.nan)


def _masked_median(x, valid):
    """Median over the valid slots (== pandas .median, linear midpoint)."""
    n = valid.sum(dim=-1)
    sx = torch.sort(_masked(x, valid, _BIG), dim=-1).values
    mid = (n - 1).clamp(min=0) // 2
    return (_take(sx, mid) + _take(sx, mid + (n % 2 == 0).long())) / 2.0


def mcc(y_bin, y_score, valid=None, device=None) -> torch.Tensor:
    """Matthews correlation after binarising the scores at their median
    (pred = score >= median); a zero denominator gives 0.0 (sklearn), an
    all-NaN label column NaN."""
    y_bin = _f64(y_bin, device)
    y_score = _f64(y_score, y_bin.device)
    valid = _valid_like(valid, y_bin)
    med = _masked_median(y_score, valid)
    pred = (y_score >= med.unsqueeze(-1)) & valid
    t = (y_bin > 0.5) & valid
    tp = _count(pred & t)
    fp = _count(pred & ~t & valid)
    fn = _count(~pred & t)
    tn = _count(~pred & ~t & valid)
    num = tp * tn - fp * fn
    den = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn))
    val = torch.where(den > 0, num / den, 0.0)
    return torch.where((valid & ~torch.isnan(y_bin)).sum(dim=-1) > 0, val, torch.nan)


def _ordinal_ranks_desc(x, valid):
    """1-based ranks of -x in stable argsort order (argsort of argsort)."""
    order = torch.argsort(_masked(-x, valid, _BIG), dim=-1, stable=True)
    n = x.shape[-1]
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(1, n + 1, device=x.device).expand_as(order))
    return ranks


def ndcg(y_true, y_score, valid=None, top_percent: float = 10.0, device=None) -> torch.Tensor:
    """The reference's quantile NDCG (calc_ndcg, performance_DMS_benchmarks
    .py:14-70): min-max normalised gains, k = floor(n * top / 100), ordinal
    ranks of -score, zero-gain items left out of DCG and IDCG, 0.0 when no
    positive gain ranks in the top k."""
    y_true = _f64(y_true, device)
    y_score = _f64(y_score, y_true.device)
    valid = _valid_like(valid, y_true)
    n = _count(valid)
    k = torch.floor(n * (top_percent / 100.0)).unsqueeze(-1)
    tmin = _masked(y_true, valid, _BIG).amin(dim=-1, keepdim=True)
    tmax = _masked(y_true, valid, -_BIG).amax(dim=-1, keepdim=True)
    gains = torch.where(valid, (y_true - tmin) / (tmax - tmin).clamp(min=1e-30), 0.0)

    def dcg(ranks):
        top = valid & (ranks <= k) & (gains != 0)
        return torch.where(top, gains / torch.log2(ranks.to(F64) + 1.0), 0.0).sum(dim=-1), top

    got, in_top = dcg(_ordinal_ranks_desc(y_score, valid))
    ideal, _ = dcg(_ordinal_ranks_desc(gains, valid))
    return torch.where(in_top.sum(dim=-1) > 0, got / ideal.clamp(min=1e-30), 0.0)


def _percentile_linear(x, valid, q):
    """np.percentile(x, q) with linear interpolation over the valid slots."""
    n = valid.sum(dim=-1)
    sx = torch.sort(_masked(x, valid, _BIG), dim=-1).values
    pos = (q / 100.0) * (n - 1).to(F64)
    lo, hi = torch.floor(pos).long(), torch.ceil(pos).long()
    frac = pos - lo
    return _take(sx, lo) * (1 - frac) + _take(sx, hi) * frac


def top_k_recall(y_true, y_score, valid=None, top_true: float = 10.0,
                 top_model: float = 10.0, device=None) -> torch.Tensor:
    """Recall of the true top-10% set by the model's top-10% set
    (calc_toprecall, performance_DMS_benchmarks.py:71-78)."""
    y_true = _f64(y_true, device)
    y_score = _f64(y_score, y_true.device)
    valid = _valid_like(valid, y_true)
    thr_t = _percentile_linear(y_true, valid, 100.0 - top_true).unsqueeze(-1)
    thr_m = _percentile_linear(y_score, valid, 100.0 - top_model).unsqueeze(-1)
    top_t = valid & (y_true >= thr_t)
    top_m = valid & (y_score >= thr_m)
    denom = _count(top_t)
    return torch.where(denom > 0, _count(top_t & top_m) / denom, 0.0)


def assay_metrics(y_true, y_bin, y_score, valid, device=None) -> Dict[str, torch.Tensor]:
    """All five metrics of one (padded) assay, or of a batch of them on the
    leading axes, on ``device`` (default: where the inputs are)."""
    y_true = _f64(y_true, device)
    dev = y_true.device
    y_bin, y_score = _f64(y_bin, dev), _f64(y_score, dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    return {
        "Spearman": spearman(y_true, y_score, valid),
        "AUC": auc(y_bin, y_score, valid),
        "MCC": mcc(y_bin, y_score, valid),
        "NDCG": ndcg(y_true, y_score, valid),
        "Top_recall": top_k_recall(y_true, y_score, valid),
    }


def batched_assay_metrics(y_true, y_bin, y_score, valid, device=None) -> Dict[str, torch.Tensor]:
    """``assay_metrics`` over (B, N) inputs: one row per assay or model
    column, padded to N with valid=False; each (B,) result equals the
    row's own unpadded call."""
    if np.ndim(valid) != 2:
        raise ValueError(f"batched_assay_metrics takes (B, N) inputs, got {np.shape(valid)}")
    return assay_metrics(y_true, y_bin, y_score, valid, device=device)


def metrics_to_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """One device-to-host copy of a metrics dict, in METRICS order."""
    stacked = torch.stack([out[m] for m in METRICS]).cpu().numpy()
    return {m: stacked[i] for i, m in enumerate(METRICS)}


def assay_metrics_host(y_true, y_bin, y_score, device="cuda") -> Dict[str, float]:
    """Variable-length numpy inputs -> {metric: float}, computed on ``device``."""
    device = resolve_device(device)
    y_true = np.asarray(y_true, dtype=np.float64)
    out = metrics_to_numpy(assay_metrics(y_true, y_bin, y_score,
                                         np.ones(y_true.shape, dtype=bool), device=device))
    return {m: float(v) for m, v in out.items()}
