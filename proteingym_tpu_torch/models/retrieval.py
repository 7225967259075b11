"""Inference-time retrieval for Tranception / TranceptEVE (counterpart of
proteingym_tpu/models/retrieval.py): the MSA pseudocount prior, the EVE
VAE prior and the fusion of both into the AR model's log-probs.

- MSA prior: weighted pseudocounts with base rate 1e-5 after a
  Hamming-similarity >= 0.2 filter against the focus sequence (ref
  tranception/utils/msa_utils.py:63-138), in float64 numpy, vectorised:
  per-column weighted counts instead of an (N, L, 25) one-hot.
- Fusion: fused = (1-beta) * ((1-alpha) * AR + alpha * MSA) + beta * EVE
  on the amino-acid slice of the vocabulary inside the (window x MSA)
  overlap, without renormalisation (ref trancepteve/model_pytorch.py:
  1090-1120; Tranception alone is beta = 0). EVE rows of -inf (non-focus
  columns) fall back to the MSA-only mix, all-zero prior rows to the AR
  model alone. It runs on the device, in float32, over (batch, time)
  positions, for both reading directions.
- alpha and beta from the processed MSA depth (ref :722-763).
- EVE prior: the log-space average of Bayesian-decoder draws at the WT
  latent, scattered into full-sequence coordinates, -inf elsewhere (ref
  :975-1001).
- Recalibration: temperature matching of a prior's mean log-prob to the
  transformer's (ref :855-905).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

NEG_INF = -np.inf
_AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"
DRAWS_PER_STEP = 8  # EVE prior draws decoded together


def _byte_codes(sequences: Sequence[str], table: np.ndarray) -> np.ndarray:
    """(N, L) codes of equal-length rows through a 256-entry table."""
    lengths = {len(s) for s in sequences}
    if len(lengths) > 1:
        raise ValueError(f"rows of several lengths: {sorted(lengths)[:5]}")
    buf = np.frombuffer("".join(sequences).encode("latin-1"), dtype=np.uint8)
    return table[buf].reshape(len(sequences), -1)


def _aa_table(offset: int, upper: bool) -> np.ndarray:
    """256-entry table: amino acid i -> offset + i, else -1 (lowercase
    letters too when ``upper``)."""
    table = np.full(256, -1, dtype=np.int64)
    for i, a in enumerate(_AA_ORDER):
        table[ord(a)] = offset + i
        if upper:
            table[ord(a.lower())] = offset + i
    return table


def hamming_filter(sequences: Sequence[str], min_similarity: float = 0.2):
    """Indices of the rows whose Hamming similarity to the first (focus)
    row is >= ``min_similarity`` (ref msa_utils.py:80-90): the focus's
    amino-acid columns that a row matches, over the focus's amino-acid
    count; gaps and other characters never match."""
    raw = _byte_codes(sequences, np.arange(256))
    focus = raw[0]
    is_aa = _aa_table(0, upper=False)[focus] >= 0
    denom = int(is_aa.sum())
    if not denom:
        return []
    matches = ((raw == focus) & is_aa).sum(axis=1)
    return np.nonzero(matches / denom >= min_similarity)[0].tolist()


def msa_prior(
    sequences: Sequence[str],
    weights: Optional[np.ndarray],
    msa_start: int,
    msa_end: int,
    full_len: int,
    n_special: int = 5,
    base_rate: float = 1e-5,
    filter_msa: bool = True,
) -> np.ndarray:
    """Weighted-pseudocount amino-acid prior over the 25-token vocabulary,
    (full_len, n_special + 20) float64 probabilities; rows outside
    [msa_start, msa_end) (0-indexed full-sequence coordinates) are zero.

    sequences: aligned focus-column rows, focus first. Each row adds its
    weight to the count of its letter (any case) at each column; a gap or
    another character adds none. The pseudocount adds ``base_rate`` x
    weight to every token of every column."""
    if weights is None:
        weights = np.ones(len(sequences))
    weights = np.asarray(weights, dtype=np.float64)
    if filter_msa:
        keep = hamming_filter(sequences)
        sequences = [sequences[i] for i in keep]
        weights = weights[keep]
    vocab_size = n_special + len(_AA_ORDER)
    length = len(sequences[0])
    if msa_end - msa_start != length:
        raise ValueError(f"MSA window [{msa_start},{msa_end}) does not match alignment "
                         f"width {length}")
    codes = _byte_codes(sequences, _aa_table(n_special, upper=True))
    rows, cols = np.nonzero(codes >= 0)
    counts = np.bincount(cols * vocab_size + codes[rows, cols], weights=weights[rows],
                         minlength=length * vocab_size).reshape(length, vocab_size)
    weighted = counts + base_rate * weights.sum()  # sum over rows of (onehot + base) * w
    avg = weighted / weighted.sum(axis=1, keepdims=True)
    prior = np.zeros((full_len, vocab_size), dtype=np.float64)
    prior[msa_start:msa_end] = avg
    return prior


def log_msa_prior(*args, **kwargs) -> np.ndarray:
    with np.errstate(divide="ignore"):
        return np.log(msa_prior(*args, **kwargs))


@torch.no_grad()
def eve_log_prior(
    eve_models,
    focus_seq: str,
    focus_cols: np.ndarray,
    msa_start: int,
    full_len: int,
    num_samples: int = 200_000,
    seed: int = 42,
    n_special: int = 5,
    sample_chunk: int = 512,
) -> np.ndarray:
    """Ensemble-averaged EVE log prior in full-sequence coordinates,
    (full_len, n_special + 20) float32.

    For each model (an ``eve.EveModel``): encode the WT focus sequence,
    then average the decoder's log-softmax over ``max(1, num_samples //
    sample_chunk) * sample_chunk`` draws of the latent and of every decoder
    weight (the JAX package's count: 19,968 of 20,000), summed in float32
    and divided by the count; then average over the models. Model i draws
    from a generator seeded ``seed + i``, ``DRAWS_PER_STEP`` draws at a
    time (each holds a sample of every decoder weight: ~86 MB at the
    default architecture over 240 columns). Non-focus columns and the
    special tokens are -inf."""
    from proteingym_tpu_torch.models import eve as eve_mod

    n_draws = max(1, num_samples // sample_chunk) * sample_chunk
    acc = 0.0
    for i, model in enumerate(eve_models):
        device = next(model.parameters()).device
        gen = torch.Generator(device=device).manual_seed(seed + i)
        x = torch.from_numpy(eve_mod.onehot_sequence(focus_seq)[None]).to(device)
        mu, logvar = model.encode(x)
        std = torch.exp(0.5 * logvar)
        total = torch.zeros(x.shape[1:], device=device)
        for d0 in range(0, n_draws, DRAWS_PER_STEP):
            s = min(DRAWS_PER_STEP, n_draws - d0)
            z = mu + std * torch.randn((s, *mu.shape), generator=gen, device=device)
            total += model.decode(z, generator=gen).sum(dim=(0, 1))
        acc = acc + (total / n_draws).cpu().numpy()
    prior = np.full((full_len, n_special + len(_AA_ORDER)), NEG_INF, dtype=np.float32)
    prior[msa_start + np.asarray(focus_cols), n_special:] = acc / len(eve_models)
    return prior


def msa_alpha(msa_depth: int, retrieval_type: str = "TranceptEVE") -> float:
    if retrieval_type == "Tranception":
        return 0.6
    if msa_depth < 10:
        return 0.0
    if msa_depth < 10**2:
        return 0.1
    if msa_depth < 10**3:
        return 0.3
    if msa_depth < 10**5:
        return 0.4
    return 0.5


def eve_beta(eve_depth: int, retrieval_type: str = "TranceptEVE") -> float:
    if retrieval_type == "Tranception":
        return 0.0
    if eve_depth < 10:
        return 0.0
    if eve_depth < 10**2:
        return 0.3
    if eve_depth < 10**3:
        return 0.6
    if eve_depth < 10**5:
        return 0.7
    return 0.8


def recalibrate_log_prior(
    log_prior_slice: np.ndarray,
    target_mean: float,
    distance_stop_criterion: float = 0.001,
    max_steps: int = 1000,
) -> np.ndarray:
    """Temperature-scale a log-prob table, renormalising each row, until
    its mean is within ``distance_stop_criterion`` of ``target_mean``
    (the transformer's mean WT log-prob)."""
    out = np.asarray(log_prior_slice, dtype=np.float64)
    loss = abs(out.mean() - target_mean)
    step = 0
    while loss > distance_stop_criterion:
        t = out.mean() / target_mean
        shifted = out / t
        out = shifted - _logsumexp_rows(shifted)
        loss = abs(out.mean() - target_mean)
        step += 1
        if step > max_steps:
            break
    return out


def _logsumexp_rows(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


class Fusion:
    """The priors of one assay on the device, applied to shifted AR
    log-probs: ``fusion(shift_logps, targets, starts, ends, reverse)``."""

    def __init__(self, msa_lp, msa_start, msa_end, alpha, eve_lp=None, beta=0.0,
                 n_special=5):
        self.msa_lp, self.eve_lp = msa_lp, eve_lp
        self.msa_start, self.msa_end, self.n_special = msa_start, msa_end, n_special
        self.alpha, self.beta = alpha, beta

    def __call__(self, shift_logps, targets, starts, ends, reverse):
        """Masked prior mixing over (batch, time) positions.

        Shift index t sits at full-sequence position start + t (L->R) or
        end - 1 - t (R->L); mixing applies where that position lies inside
        [msa_start, msa_end), the target token is an amino acid and the MSA
        prior row is not all zero, and only to the amino-acid columns."""
        t_idx = torch.arange(shift_logps.shape[1], device=shift_logps.device)[None, :]
        pos = ends[:, None] - 1 - t_idx if reverse else starts[:, None] + t_idx
        in_range = (pos >= self.msa_start) & (pos < self.msa_end)
        mask = (in_range & (targets >= self.n_special))[..., None]
        pos_c = pos.clamp(0, self.msa_lp.shape[0] - 1)
        msa_rows = self.msa_lp[pos_c]  # (B, T, V)
        aa_cols = torch.arange(msa_rows.shape[-1], device=msa_rows.device) >= self.n_special
        mask = mask & (msa_rows != 0.0).any(dim=-1, keepdim=True) & aa_cols
        mixed = (1.0 - self.alpha) * shift_logps + self.alpha * msa_rows
        if self.eve_lp is not None:
            eve_rows = self.eve_lp[pos_c]
            finite = torch.isfinite(eve_rows)
            beta_eff = torch.where(finite, self.beta, 0.0)
            mixed = (1.0 - beta_eff) * mixed + beta_eff * torch.where(finite, eve_rows, 0.0)
        return torch.where(mask, mixed, shift_logps)


def make_fusion(
    msa_log_prior: np.ndarray,
    msa_start: int,
    msa_end: int,
    alpha: float,
    eve_prior: Optional[np.ndarray] = None,
    beta: float = 0.0,
    n_special: int = 5,
    device="cuda",
) -> Fusion:
    """A ``Fusion`` for ``ar_scoring.batched_ar_loglik``: the prior tables
    as float32 tensors on ``device``, alpha and beta as float32 scalars
    (the JAX package mixes in float32)."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
    return Fusion(f32(msa_log_prior), int(msa_start), int(msa_end), f32(alpha),
                  None if eve_prior is None else f32(eve_prior), f32(beta), n_special)
