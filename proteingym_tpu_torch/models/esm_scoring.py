"""Masked-LM fitness scoring: WT marginals, masked marginals and
pseudo-perplexity (counterpart of proteingym_tpu/models/esm_scoring.py).

Works for any token-level model ``logits_fn(tokens (B, T)) -> (B, T, V)``;
an ``nn.Module`` carries its own weights, so the JAX ``params`` argument
has no counterpart. Masked rows are built on the device from one token
upload, one chunk of rows per forward, and only the masked row of each
forward is normalised (``row_log_softmax_gather``). WT marginals take one
unmasked forward; a sequence longer than the window runs all its
overlapping windows in one batched forward and is stitched on the device
with the reference's sigmoid edge weights.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.data.mutants import apply_mutant, is_wt_row, mutations_to_arrays
from proteingym_tpu_torch.data.windows import get_optimal_window
from proteingym_tpu_torch.models.esm2 import ALPHABET, EsmAlphabet
from proteingym_tpu_torch.ops.gather_logprobs import row_log_softmax_gather
from proteingym_tpu_torch.pipeline.profiler import PARSE, PLAN, READBACK, ROWS, UPLOAD, span


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
def wt_marginal_table(logits_fn, tokens: np.ndarray,
                      device: Optional[torch.device] = None) -> torch.Tensor:
    """One unmasked forward of the (T,) tokens -> (T, V) float32 log-softmax
    table on ``device`` (default: the module's)."""
    device = _device_of(logits_fn) if device is None else torch.device(device)
    batch = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=device)[None]
    return torch.log_softmax(logits_fn(batch)[0].float(), dim=-1)


def esm_overlap_weights(window: int = 1024, ramp: int = 256,
                        slope: float = 16.0) -> np.ndarray:
    """Exact per-token stitching weights, float64: ones, with
    w[i] = sigma((i - ramp/2) / slope) for i in [1, ramp] and the mirror on
    [window-2-ramp, window-2]."""
    w = np.ones(window, dtype=np.float64)
    half = ramp // 2
    for i in range(1, ramp + 1):
        w[i] = 1.0 / (1.0 + math.exp(-(i - half) / slope))
    for i in range(window - 2 - ramp, window - 1):
        w[i] = 1.0 / (1.0 + math.exp((i - (window - 2) + half) / slope))
    return w


def overlapping_window_plan(total_len: int, window: int = 1024,
                            step: int = 511) -> List[int]:
    """Start offsets of the windows [s, s+window): left windows advance by
    ``step`` from 0 while right windows retreat by ``step`` from the end,
    until they overlap; a central window is added when the final overlap is
    thinner than ``step``."""
    starts = []
    sl, sr = 0, total_len - window
    while True:
        starts.append(sl)
        starts.append(sr)
        if sl + window - 1 > sr:
            break
        sl += step
        sr -= step
    final_overlap = (sl + window - 1) - sr + 1
    if final_overlap < step:
        starts.append(int(total_len / 2) - window // 2)
    return starts


@torch.no_grad()
def wt_marginal_table_overlapping(logits_fn, tokens: np.ndarray, window: int = 1024,
                                  device: Optional[torch.device] = None) -> torch.Tensor:
    """WT marginals of a token vector longer than ``window``: every window of
    ``overlapping_window_plan`` (cut from the tokens, BOS and EOS included)
    in one batched forward, then the float32 weighted stitch on the device.
    ``total <= window`` is the single forward."""
    tokens = np.asarray(tokens)
    total = tokens.shape[0]
    if total <= window:
        return wt_marginal_table(logits_fn, tokens, device=device)
    device = _device_of(logits_fn) if device is None else torch.device(device)
    starts = overlapping_window_plan(total, window=window)
    toks_d = torch.as_tensor(tokens, dtype=torch.long, device=device)
    positions = torch.arange(window, device=device)
    batch = toks_d[torch.as_tensor(starts, device=device)[:, None] + positions]
    logps = torch.log_softmax(logits_fn(batch).float(), dim=-1)
    w = torch.as_tensor(esm_overlap_weights(window), dtype=torch.float32, device=device)
    acc = torch.zeros(total, logps.shape[-1], dtype=torch.float32, device=device)
    wsum = torch.zeros(total, dtype=torch.float32, device=device)
    for idx, s in enumerate(starts):
        acc[s:s + window] += logps[idx] * w[:, None]
        wsum[s:s + window] += w
    return acc / wsum[:, None]


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
    with span(PLAN):
        toks = _pad_to_bucket(tokens, pad_to_multiple, pad_idx)
        toks_d = torch.as_tensor(toks, dtype=torch.long, device=device)
        lanes = torch.arange(chunk, device=device)

    if total <= window:
        with span(PLAN):
            n_pad = _round_up(toks.shape[0], chunk)
            offsets = np.zeros(n_pad, np.int64)
            offsets[:total] = np.arange(total)
            offs_d = torch.as_tensor(offsets, device=device).view(-1, chunk)
        parts = []
        for offs in offs_d:
            with span(ROWS):
                rows = toks_d.expand(chunk, -1).clone()
                with span(UPLOAD):  # the scalar's copy waits for the last forward
                    rows[lanes, offs] = mask_idx
            parts.append(row_log_softmax_gather(logits_fn(rows), offs))
        return torch.cat(parts)[:total]

    if scoring_window != "optimal":
        raise NotImplementedError(
            "overlapping windows are not defined for masked-marginals "
            "(matches reference behavior)"
        )
    with span(PLAN):
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
        positions = torch.arange(window, device=device)
    parts = []
    for st, offs in zip(starts_d, offs_d):
        with span(ROWS):
            rows = toks_d[st[:, None] + positions[None, :]]  # (chunk, window)
            with span(UPLOAD):
                rows[lanes, offs] = mask_idx
        parts.append(row_log_softmax_gather(logits_fn(rows), offs))
    return torch.cat(parts)[:total]


def pseudo_ppl(
    logits_fn,
    sequence: str,
    alphabet: EsmAlphabet = ALPHABET,
    chunk: int = 32,
    pad_to_multiple: Optional[int] = None,
    device: Optional[torch.device] = None,
) -> float:
    """Sum over positions of log p(x_i | x with i masked), read from the
    masked-marginal table (its default window of 1024 tokens, as the JAX
    call has)."""
    tokens = alphabet.tokenize(sequence)
    table = masked_marginal_table(
        logits_fn, tokens, mask_idx=alphabet.mask_idx, chunk=chunk,
        pad_to_multiple=pad_to_multiple, pad_idx=alphabet.padding_idx,
        device=device,
    )
    rows = torch.arange(1, 1 + len(sequence), device=table.device)
    idx = torch.as_tensor(tokens[1:1 + len(sequence)], dtype=torch.long, device=table.device)
    return float(table[rows, idx].sum())


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
    with span(PARSE):
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
            with span(READBACK):
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
    """Score all mutants of one assay with the requested strategy:
    ``wt-marginals`` (overlapping windows beyond ``window`` tokens),
    ``masked-marginals``, or ``pseudo-ppl`` (pppl(mutant) - pppl(wt), in
    float64)."""
    with span(PLAN):
        tokens = alphabet.tokenize(sequence)
    if strategy == "wt-marginals":
        table = wt_marginal_table_overlapping(logits_fn, tokens, window=window, device=device)
    elif strategy == "masked-marginals":
        table = masked_marginal_table(
            logits_fn,
            tokens,
            mask_idx=alphabet.mask_idx,
            chunk=chunk,
            window=window,
            scoring_window=scoring_window,
            pad_to_multiple=pad_to_multiple,
            pad_idx=alphabet.padding_idx,
            device=device,
        )
    elif strategy == "pseudo-ppl":
        kw = dict(alphabet=alphabet, chunk=chunk, pad_to_multiple=pad_to_multiple,
                  device=device)
        wt_ppl = pseudo_ppl(logits_fn, sequence, **kw)
        out = np.zeros(len(mutants))
        for i, m in enumerate(mutants):
            mut_seq = apply_mutant(sequence, m, start_idx=offset_idx)
            out[i] = pseudo_ppl(logits_fn, mut_seq, **kw) - wt_ppl
        return out
    else:
        raise ValueError(f"Unknown strategy: {strategy}")
    return score_mutants_from_table(
        table, mutants, sequence, offset_idx=offset_idx, alphabet=alphabet
    )
