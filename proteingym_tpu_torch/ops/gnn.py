"""Graph construction for the structure models (counterpart of
``knn_graph`` in proteingym_tpu/ops/gnn.py)."""

from __future__ import annotations

import torch


def knn_graph(coords: torch.Tensor, k: int) -> torch.Tensor:
    """(L, 3) coordinates -> (L, min(k, L - 1)) neighbour indices, nearest
    first, self excluded. Squared distances are summed one coordinate at a
    time in the input dtype (so every device ranks the same numbers), self
    is pushed out by 1e9, and a stable ascending sort breaks ties to the
    lower index, as ``jax.lax.top_k`` does."""
    L = coords.shape[0]
    diff = coords[:, None] - coords[None]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    d2 = d2 + torch.eye(L, dtype=d2.dtype, device=d2.device) * 1e9
    return torch.sort(d2, dim=-1, stable=True).indices[:, :min(k, L - 1)]
