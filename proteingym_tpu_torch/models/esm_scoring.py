"""Masked-marginal fitness scoring (counterpart of
proteingym_tpu/models/esm_scoring.py).

Works for any token-level model ``logits_fn(tokens (B, T)) -> (B, T, V)``;
an ``nn.Module`` carries its own weights, so the JAX ``params`` argument
has no counterpart. Masked rows are built on the device from one token
upload, one chunk of rows per forward, and only the masked row of each
forward is normalised (``row_log_softmax_gather``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.data.mutants import is_wt_row, mutations_to_arrays
from proteingym_tpu_torch.data.windows import get_optimal_window
from proteingym_tpu_torch.models.esm2 import ALPHABET, EsmAlphabet
from proteingym_tpu_torch.ops.gather_logprobs import row_log_softmax_gather


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _pad_to_bucket(tokens: np.ndarray, pad_to_multiple: Optional[int],
                   pad_idx: Optional[int]) -> np.ndarray:
    """Right-pad a (T,) token vector so T hits the next bucket boundary."""
    t = tokens.shape[0]
    if pad_to_multiple is None or t % pad_to_multiple == 0:
        return tokens
    pad_idx = ALPHABET.padding_idx if pad_idx is None else pad_idx
    bucket = _round_up(t, pad_to_multiple)
    return np.concatenate([tokens, np.full(bucket - t, pad_idx, tokens.dtype)])


def _device_of(logits_fn) -> torch.device:
    if isinstance(logits_fn, nn.Module):
        return next(logits_fn.parameters()).device
    return torch.device("cpu")


@torch.no_grad()
def masked_marginal_table(
    logits_fn,
    tokens: np.ndarray,
    mask_idx: Optional[int] = None,
    chunk: int = 32,
    window: int = 1024,
    scoring_window: str = "optimal",
    pad_to_multiple: Optional[int] = None,
    pad_idx: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> torch.Tensor:
    """(T, V) float32 log-prob table on ``device`` (default: the module's),
    row i from a forward with token i masked.

    Sequences longer than ``window`` tokens score each position inside its
    optimal window. ``pad_to_multiple`` right-pads the rows with ``pad_idx``
    to a length bucket (pads are attention-masked); the chunk count derives
    from the bucketed length, as in the JAX package, and the extra rows
    are dropped."""
    mask_idx = ALPHABET.mask_idx if mask_idx is None else mask_idx
    device = _device_of(logits_fn) if device is None else torch.device(device)
    tokens = np.asarray(tokens)
    total = tokens.shape[0]
    toks = _pad_to_bucket(tokens, pad_to_multiple, pad_idx)
    toks_d = torch.as_tensor(toks, dtype=torch.long, device=device)
    lanes = torch.arange(chunk, device=device)

    if total <= window:
        n_pad = _round_up(toks.shape[0], chunk)
        offsets = np.zeros(n_pad, np.int64)
        offsets[:total] = np.arange(total)
        offs_d = torch.as_tensor(offsets, device=device).view(-1, chunk)
        parts = []
        for offs in offs_d:
            rows = toks_d.expand(chunk, -1).clone()
            rows[lanes, offs] = mask_idx
            parts.append(row_log_softmax_gather(logits_fn(rows), offs))
        return torch.cat(parts)[:total]

    if scoring_window != "optimal":
        raise NotImplementedError(
            "overlapping windows are not defined for masked-marginals "
            "(matches reference behavior)"
        )
    n_pad = _round_up(
        total if pad_to_multiple is None else _round_up(total, pad_to_multiple),
        chunk,
    )
    starts = np.zeros(n_pad, np.int64)
    offsets = np.zeros(n_pad, np.int64)
    for i in range(total):
        start, _end = get_optimal_window(i, total, window)
        starts[i] = start
        offsets[i] = i - start
    starts_d = torch.as_tensor(starts, device=device).view(-1, chunk)
    offs_d = torch.as_tensor(offsets, device=device).view(-1, chunk)
    span = torch.arange(window, device=device)
    parts = []
    for st, offs in zip(starts_d, offs_d):
        rows = toks_d[st[:, None] + span[None, :]]  # (chunk, window)
        rows[lanes, offs] = mask_idx
        parts.append(row_log_softmax_gather(logits_fn(rows), offs))
    return torch.cat(parts)[:total]


def score_mutants_from_table(
    table,
    mutants: Sequence[str],
    sequence: str,
    offset_idx: int = 1,
    alphabet: EsmAlphabet = ALPHABET,
    bos_offset: int = 1,
) -> np.ndarray:
    """For each mutant string, the sum over its mutated positions of
    log p(mt) - log p(wt) read from the (T, V) table (WT rows score 0)."""
    positions, _, _, valid = mutations_to_arrays(mutants, start_idx=offset_idx)
    n, d = positions.shape
    wt_tok = np.zeros((n, d), dtype=np.int64)
    mt_tok = np.zeros((n, d), dtype=np.int64)
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        for j, tok in enumerate(m.split(":")):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if sequence[pos] != wt:
                raise ValueError(
                    f"Mutant {tok}: wild-type mismatch at position {pos}"
                )
            wt_tok[i, j] = alphabet.get_idx(wt)
            mt_tok[i, j] = alphabet.get_idx(mt)
    if torch.is_tensor(table):
        table = table.float().cpu().numpy()
    table = np.asarray(table, dtype=np.float32)
    rows = positions + bos_offset
    diff = table[rows, mt_tok] - table[rows, wt_tok]
    return np.where(valid, diff, np.float32(0.0)).sum(axis=1, dtype=np.float32)


def score_assay(
    logits_fn,
    sequence: str,
    mutants: Sequence[str],
    strategy: str = "masked-marginals",
    offset_idx: int = 1,
    alphabet: EsmAlphabet = ALPHABET,
    chunk: int = 32,
    window: int = 1024,
    scoring_window: str = "optimal",
    pad_to_multiple: Optional[int] = 64,
    device: Optional[torch.device] = None,
) -> np.ndarray:
    """Score all mutants of one assay with the requested strategy."""
    if strategy in ("wt-marginals", "pseudo-ppl"):
        raise NotImplementedError(
            f"scoring strategy {strategy!r} is not ported yet: ROADMAP.md, "
            "Queue 1, item 7 (wt-marginals and pseudo-ppl)"
        )
    if strategy != "masked-marginals":
        raise ValueError(f"Unknown strategy: {strategy}")
    table = masked_marginal_table(
        logits_fn,
        alphabet.tokenize(sequence),
        mask_idx=alphabet.mask_idx,
        chunk=chunk,
        window=window,
        scoring_window=scoring_window,
        pad_to_multiple=pad_to_multiple,
        pad_idx=alphabet.padding_idx,
        device=device,
    )
    return score_mutants_from_table(
        table, mutants, sequence, offset_idx=offset_idx, alphabet=alphabet
    )
