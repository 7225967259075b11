"""Ring attention: exact attention with the sequence sharded over a process
group (counterpart of proteingym_tpu/ops/ring_attention.py).

The reference handles long sequences only by windowing (SURVEY.md §5).
Ring attention scores a full-length sequence exactly with activations
sharded over devices: each rank holds its own T / n rows of Q/K/V; the K/V
blocks and their key mask rotate around the group (``dist.batch_isend_irecv``
to the next rank, from the previous one) while every rank folds the
visiting block into flash-style running (max, sum, accumulator) statistics
in float32 (``NEG_INF`` for masked keys, the sum floored at 1e-30). After n
blocks every query has seen every key and the normalized output, cast back
to q's dtype, is exact; no (T, T) tensor exists on one rank.

The fold is plain torch (the JAX fold is einsums under ``shard_map``, no
Pallas kernel): q.k and p.v take their operands in float32 (exact products
of bf16 inputs, float32 sums, the JAX einsums' ``preferred_element_type``),
and p is rounded to v's dtype before its product, as in JAX. Blocks are
folded in the JAX ring's order: at hop j a rank holds the block of the rank
j places before it. The last block is not sent on (JAX's ``ppermute`` after
the last fold is discarded), so a group of one communicates nothing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e30


def _rotate(tensors, group):
    """Send each tensor to the next rank of ``group``, receive the previous
    rank's; returns the received tensors."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (rank + 1) % size)
    prv = dist.get_global_rank(group, (rank - 1) % size)
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


def ring_attention_local(q, k, v, key_mask, group, sm_scale: float):
    """This rank's shard: q/k/v (B, H, T_local, D), key_mask (B, T_local)
    bool (True = real key) -> (B, H, T_local, D) in q's dtype."""
    size = dist.get_world_size(group)
    b, h, tq, d = q.shape
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    q32 = q.float()
    # the mask travels as bytes: not every backend sends bool tensors
    k_cur, v_cur, mask_cur = k.contiguous(), v.contiguous(), key_mask.to(torch.uint8).contiguous()
    for hop in range(size):
        s = torch.matmul(q32, k_cur.float().transpose(-1, -2)) * sm_scale
        s = torch.where(mask_cur.bool()[:, None, None, :], s, torch.full_like(s, NEG_INF))
        new_m = torch.maximum(m, s.amax(dim=-1))
        correction = torch.exp(m - new_m)
        p = torch.exp(s - new_m[..., None])
        l = l * correction + p.sum(dim=-1)
        acc = acc * correction[..., None] + torch.matmul(p.to(v_cur.dtype).float(),
                                                         v_cur.float())
        m = new_m
        if hop + 1 < size:
            k_cur, v_cur, mask_cur = _rotate([k_cur, v_cur, mask_cur], group)
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    group=None,
    key_mask: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Exact (non-causal) attention with the sequence dim sharded over
    ``group`` (default: the whole world). q/k/v: (B, H, T, D), the same on
    every rank; key_mask: (B, T) True at REAL keys. Rank r of the group
    computes rows [r T / n, (r + 1) T / n) through the ring; the shards are
    gathered, so every rank returns the whole (B, H, T, D) output, as the
    JAX function returns a global array. T must divide evenly by the group
    size (pad with masked keys first)."""
    group = group or dist.group.WORLD
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    t = q.shape[2]
    if t % size:
        raise ValueError(f"T={t} does not divide over a group of {size}; pad with masked keys")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if key_mask is None:
        key_mask = torch.ones((q.shape[0], t), dtype=torch.bool, device=q.device)
    n = t // size
    mine = slice(rank * n, (rank + 1) * n)
    out = ring_attention_local(q[:, :, mine].contiguous(), k[:, :, mine], v[:, :, mine],
                               key_mask[:, mine], group, sm_scale).contiguous()
    parts = [torch.empty_like(out) for _ in range(size)]
    dist.all_gather(parts, out, group=group)
    return torch.cat(parts, dim=2)
