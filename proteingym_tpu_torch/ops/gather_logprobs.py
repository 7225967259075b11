"""Gather-then-log-softmax for masked-marginal scoring (counterpart of
proteingym_tpu/ops/gather_logprobs.py).

Only the masked row of each forward is needed, so the row is gathered
first and the log-softmax runs over (B, V) instead of (B, T, V). With
V=33 this is plain PyTorch; there is nothing for a kernel to fuse.
"""

from __future__ import annotations

import torch


def row_log_softmax_gather(logits: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """out[i, :] = log_softmax(logits[i, offs[i], :]). logits (B, T, V),
    offs (B,) integer row positions; returns (B, V) float32."""
    rows = logits[torch.arange(logits.shape[0], device=logits.device), offs.long()]
    return torch.log_softmax(rows.float(), dim=-1)


def multi_log_softmax_gather(logits: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """out[i, s, :] = log_softmax(logits[i, offs[i, s], :]) for packed rows:
    logits (B, T, V), offs (B, S) -> (B, S, V) float32. Out-of-range
    offsets (empty slots) clamp to the last row; callers drop them."""
    idx = offs.long().clamp(0, logits.shape[1] - 1)
    rows = torch.gather(
        logits, 1, idx[:, :, None].expand(-1, -1, logits.shape[2])
    )
    return torch.log_softmax(rows.float(), dim=-1)
