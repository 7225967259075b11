"""Non-parametric bootstrap standard errors for leaderboard means, numpy
(counterpart of proteingym_tpu/metrics/bootstrap.py).

The resamples come from ``np.random.default_rng(seed)`` in the JAX
package's order (one ``integers(0, n, (B, n))`` draw per category, the
categories in sorted order), so the standard errors are equal to its, not
merely close.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np


def bootstrap_standard_error(
    values: np.ndarray,
    number_assay_reshuffle: int = 10000,
    seed: Optional[int] = 0,
) -> np.ndarray:
    """(n_rows, n_columns) -> SE of each column mean under row resampling
    with replacement (NaN-aware means, std with ddof=1 across resamples)."""
    rng = np.random.default_rng(seed)
    values = np.asarray(values, dtype=np.float64)
    n = values.shape[0]
    idx = rng.integers(0, n, size=(number_assay_reshuffle, n))
    sample_means = np.nanmean(values[idx], axis=1)  # (B, n_columns)
    return np.std(sample_means, axis=0, ddof=1)


def bootstrap_standard_error_functional_categories(
    values: np.ndarray,
    categories: Sequence,
    number_assay_reshuffle: int = 10000,
    seed: Optional[int] = 0,
) -> np.ndarray:
    """SE of the across-category average of within-category resample means:
    rows are resampled within each category (sorted order, rows with no
    category left out, as pandas' groupby does), the category means are
    averaged, and the std (ddof=1) is taken over the replicates."""
    rng = np.random.default_rng(seed)
    values = np.asarray(values, dtype=np.float64)
    categories = np.asarray(categories, dtype=object)
    replicates = None
    keys = sorted({c for c in categories if c is not None})
    for key in keys:
        group = values[categories == key]
        idx = rng.integers(0, group.shape[0], size=(number_assay_reshuffle, group.shape[0]))
        with warnings.catch_warnings():
            # all-NaN model columns (absent scores) legitimately yield NaN
            warnings.simplefilter("ignore", category=RuntimeWarning)
            means = np.nanmean(group[idx], axis=1)
        replicates = means if replicates is None else replicates + means
    return np.std(replicates / len(keys), axis=0, ddof=1)
