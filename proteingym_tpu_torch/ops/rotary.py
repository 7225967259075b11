"""Rotary position embeddings (RoPE), ESM2 "rotate_half" convention
(counterpart of proteingym_tpu/ops/rotary.py)."""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _cos_sin_cache(seq_len: int, dim: int, base: float = 10000.0):
    """(T, D) float32 cos/sin tables, the same numpy formula as the JAX
    package so both sides rotate by identical values."""
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    t = np.arange(seq_len, dtype=np.float32)
    freqs = np.outer(t, inv_freq)  # (T, dim/2)
    emb = np.concatenate([freqs, freqs], axis=-1)  # (T, dim)
    return np.cos(emb), np.sin(emb)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rotary_bhtd(q: torch.Tensor, k: torch.Tensor, base: float = 10000.0):
    """RoPE on (B, H, T, D) q and k along T, rotated in float32 and rounded
    back to the input dtype."""
    t, d = q.shape[2], q.shape[3]
    cos_np, sin_np = _cos_sin_cache(t, d, base)
    cos = torch.from_numpy(cos_np).to(q.device)
    sin = torch.from_numpy(sin_np).to(q.device)

    def rot(x):
        xf = x.float()
        return (xf * cos + rotate_half(xf) * sin).to(x.dtype)

    return rot(q), rot(k)
