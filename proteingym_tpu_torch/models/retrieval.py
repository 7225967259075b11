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
- Indels: the priors realigned to every indel sequence by the native Gotoh
  aligner (the role of Clustal Omega, ref tranception/utils/
  msa_utils.py:141-192), one table per unique sequence, stacked on the
  device and read row by row by the per-row fusion.
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


def msa_alpha(msa_depth: int, indel_mode: bool = False,
              retrieval_type: str = "TranceptEVE") -> float:
    if retrieval_type == "Tranception":
        return 0.6
    if indel_mode:
        return 0.0 if msa_depth < 10 else 0.5
    if msa_depth < 10:
        return 0.0
    if msa_depth < 10**2:
        return 0.1
    if msa_depth < 10**3:
        return 0.3
    if msa_depth < 10**5:
        return 0.4
    return 0.5


def eve_beta(eve_depth: int, indel_mode: bool = False,
             retrieval_type: str = "TranceptEVE") -> float:
    if retrieval_type == "Tranception":
        return 0.0
    if indel_mode:
        return 0.0 if eve_depth < 10 else 0.1
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


def _aa_codes(seq: str) -> np.ndarray:
    """The aligner's int8 codes: amino acid i (any case) -> i + 1, else 0."""
    return _byte_codes([seq], _aa_table(1, upper=True))[0].clip(0).astype(np.int8)


def _realigned_rows(a_cols: np.ndarray, b_cols: np.ndarray) -> np.ndarray:
    """For each query position, the reference position aligned to it, or
    -1 where the query residue faces a gap in the reference."""
    ref_of_col = np.full(len(a_cols) + len(b_cols), -1, dtype=np.int64)
    aligned = a_cols >= 0
    ref_of_col[a_cols[aligned]] = np.nonzero(aligned)[0]
    return ref_of_col[b_cols]


def _prior_on_rows(prior: np.ndarray, msa_start: int, msa_end: int, ref_rows: np.ndarray):
    """``(prior in the query frame, start, end)``: the rows before
    ``msa_start`` kept, then one row per query residue from ``msa_start``
    on: the aligned reference row of the region, or all zero. float64."""
    vocab = prior.shape[1]
    new_end = msa_start + len(ref_rows)
    out = np.zeros((new_end, vocab))
    out[:msa_start] = prior[:msa_start]
    region = np.asarray(prior[msa_start:msa_end], dtype=np.float64)
    live = ref_rows >= 0
    out[msa_start:][live] = region[ref_rows[live]]
    return out, msa_start, new_end


def _align_to_reference(reference_region: str, query_parts: Sequence[str]):
    """``(a_cols, b_cols)`` of the reference region against each query part
    (the native Gotoh aligner, all pairs in one call on native threads)."""
    from proteingym_tpu_torch import native

    pairs = native.affine_align_many(_aa_codes(reference_region),
                                     [_aa_codes(q) for q in query_parts])
    return [(a_cols, b_cols) for _, a_cols, b_cols in pairs]


def update_msa_prior_indel(
    msa_log_prior: np.ndarray,
    msa_start: int,
    msa_end: int,
    reference_region: str,
    mutated_sequence: str,
):
    """Realign an indel sequence to the prior's coordinates (the role of
    Clustal Omega, ref tranception/utils/msa_utils.py:141-192, here the
    native Gotoh aligner) and rebuild the prior's rows: a reference column
    facing a query gap (a deletion) drops its row; a query residue facing a
    reference gap (an insertion) gets an all-zero row, which the fusion
    reads as AR-only. Rows before ``msa_start`` are kept.

    ``reference_region`` is the WT over [msa_start, msa_end); the query is
    the mutated sequence from ``msa_start`` on. Returns ``(prior in the
    query frame, msa_start, new_end)``, float64."""
    from proteingym_tpu_torch import native

    query = mutated_sequence[msa_start:] if msa_start else mutated_sequence
    _, a_cols, b_cols = native.affine_align(_aa_codes(reference_region), _aa_codes(query))
    return _prior_on_rows(msa_log_prior, msa_start, msa_end, _realigned_rows(a_cols, b_cols))


def _positions(shift_logps, starts, ends, reverse):
    """(B, T) full-sequence position of each shift index t: start + t
    (L->R) or end - 1 - t (R->L)."""
    t_idx = torch.arange(shift_logps.shape[1], device=shift_logps.device)[None, :]
    return ends[:, None] - 1 - t_idx if reverse else starts[:, None] + t_idx


class Fusion:
    """The priors of one assay on the device, applied to shifted AR
    log-probs: ``fusion(shift_logps, targets, starts, ends, reverse)``."""

    per_row = False

    def __init__(self, msa_lp, msa_start, msa_end, alpha, eve_lp=None, beta=0.0,
                 n_special=5):
        self.msa_lp, self.eve_lp = msa_lp, eve_lp
        self.msa_start, self.msa_end, self.n_special = msa_start, msa_end, n_special
        self.alpha, self.beta = alpha, beta

    def __call__(self, shift_logps, targets, starts, ends, reverse):
        pos = _positions(shift_logps, starts, ends, reverse)
        in_range = (pos >= self.msa_start) & (pos < self.msa_end)
        pos_c = pos.clamp(0, self.msa_lp.shape[0] - 1)
        return self._mix(shift_logps, targets, in_range, self.msa_lp[pos_c],
                         None if self.eve_lp is None else self.eve_lp[pos_c])

    def _mix(self, shift_logps, targets, in_range, msa_rows, eve_rows):
        """Masked prior mixing over (batch, time) positions: where the
        position lies inside the prior's span, the target token is an amino
        acid and the MSA prior row (B, T, V) is not all zero, and only on
        the amino-acid columns; an EVE row of -inf leaves the MSA-only mix."""
        mask = (in_range & (targets >= self.n_special))[..., None]
        aa_cols = torch.arange(msa_rows.shape[-1], device=msa_rows.device) >= self.n_special
        mask = mask & (msa_rows != 0.0).any(dim=-1, keepdim=True) & aa_cols
        mixed = (1.0 - self.alpha) * shift_logps + self.alpha * msa_rows
        if eve_rows is not None:
            finite = torch.isfinite(eve_rows)
            beta_eff = torch.where(finite, self.beta, 0.0)
            mixed = (1.0 - beta_eff) * mixed + beta_eff * torch.where(finite, eve_rows, 0.0)
        return torch.where(mask, mixed, shift_logps)


class PerRowFusion(Fusion):
    """Indel fusion: every row mixes with ITS OWN realigned prior table
    (positions are in the mutant's frame, so one WT-frame table would be
    misaligned past the first indel): ``fusion(shift_logps, targets,
    starts, ends, reverse, table_ids)``, with (n_tables,) spans and
    (n_tables, L_pad, V) stacks on the device, of which a block gathers
    only the (B, T, V) rows it reads."""

    per_row = True

    def __call__(self, shift_logps, targets, starts, ends, reverse, table_ids):
        pos = _positions(shift_logps, starts, ends, reverse)
        in_range = ((pos >= self.msa_start[table_ids][:, None])
                    & (pos < self.msa_end[table_ids][:, None]))
        pos_c = pos.clamp(0, self.msa_lp.shape[1] - 1)
        tab = table_ids[:, None]
        return self._mix(shift_logps, targets, in_range, self.msa_lp[tab, pos_c],
                         None if self.eve_lp is None else self.eve_lp[tab, pos_c])


def make_indel_fusion(
    msa_log_prior: np.ndarray,
    msa_start: int,
    msa_end: int,
    alpha: float,
    target_seq: str,
    sequences: Sequence[str],
    eve_prior: Optional[np.ndarray] = None,
    beta: float = 0.0,
    n_special: int = 5,
    device="cuda",
):
    """The per-row fusion of an indel assay and ``{sequence: table id}``.

    One table per unique sequence, then the WT: the WT-frame prior(s)
    realigned to it (``update_msa_prior_indel``). Each sequence is aligned
    once and its columns serve both tables; an EVE row at an inserted
    position is -inf (excluded from the mix), not zero, since zero is a
    valid EVE log-prob row. The stacks are padded to a multiple of 64 rows
    (0 for the MSA table, -inf for EVE) and put on ``device`` in float32."""
    uniq = list(dict.fromkeys(list(sequences) + [target_seq]))
    queries = [seq[msa_start:] if msa_start else seq for seq in uniq]
    cols = _align_to_reference(target_seq[msa_start:msa_end], queries)
    ref_rows = [_realigned_rows(a_cols, b_cols) for a_cols, b_cols in cols]
    ends = np.asarray([msa_start + len(r) for r in ref_rows], dtype=np.int64)
    l_pad = 64 * ((int(ends.max()) + 63) // 64)
    vocab = msa_log_prior.shape[1]
    msa_stack = np.zeros((len(uniq), l_pad, vocab), dtype=np.float32)
    eve_stack = None
    if eve_prior is not None:
        eve_stack = np.full((len(uniq), l_pad, vocab), -np.inf, dtype=np.float32)
    for i, rows in enumerate(ref_rows):
        tab, _, end = _prior_on_rows(msa_log_prior, msa_start, msa_end, rows)
        msa_stack[i, :end] = tab
        if eve_stack is not None:
            ev, _, _ = _prior_on_rows(eve_prior, msa_start, msa_end, rows)
            ev[~np.any(tab != 0.0, axis=-1)] = -np.inf
            eve_stack[i, :end] = ev
    dev = lambda x: torch.as_tensor(x, device=device)
    f32 = lambda x: dev(np.asarray(x, dtype=np.float32))
    fusion = PerRowFusion(dev(msa_stack), dev(np.full(len(uniq), msa_start, dtype=np.int64)),
                          dev(ends), f32(alpha), None if eve_stack is None else dev(eve_stack),
                          f32(beta), n_special)
    return fusion, {seq: i for i, seq in enumerate(uniq)}


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
