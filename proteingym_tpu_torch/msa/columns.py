"""Weighted column counts of an alignment, on the device: the statistic
RSALOR, GEMME and SiteRM start from (the JAX package builds an (N, L, 20)
one-hot and contracts it with the weights; at N=16,384 and L=240 that
one-hot is 629 MB in float64)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from proteingym_tpu_torch.devices import resolve_device


def column_counts(matrix: np.ndarray, weights: Optional[np.ndarray] = None, q: int = 20,
                  device="cuda") -> np.ndarray:
    """(L, q) float64 ``sum_n w_n [matrix[n, l] == a + 1]`` over an (N, L)
    code matrix (0 = gap, 1..q amino acids), as one weighted ``bincount``
    on ``device``; ``weights=None`` weighs every row 1."""
    dev = resolve_device(device)
    m = torch.as_tensor(np.asarray(matrix), device=dev).long()
    n, length = m.shape
    w = (torch.ones(n, dtype=torch.float64, device=dev) if weights is None
         else torch.as_tensor(np.asarray(weights, np.float64), device=dev))
    aa = m - 1
    live = aa >= 0
    cells = (torch.arange(length, device=dev) * q + aa)[live]
    counts = torch.bincount(cells, weights=w[:, None].expand(n, length)[live],
                            minlength=length * q)
    return counts.view(length, q).cpu().numpy()
