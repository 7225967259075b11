"""Profile HMM (counterpart of proteingym_tpu/models/hmm.py): an
hmmbuild-like estimate from the alignment on the host, and the forward
algorithm batched over an assay's rows on the device.

The reference runs HMMER's ``hmmbuild`` and a forward-algorithm binary and
scores log p(seq) - log p(WT) (ref proteingym/baselines/HMM/
score_hmm.py:9-111). Here:

- ``build_profile_hmm``: match emissions and M/D transitions from the
  weighted counts of the focus columns (a gap in a focus column is a
  delete state), with pseudocounts; insert emissions are the background.
  NumPy, float64, counted with one weighted ``bincount`` (no (N, L, 20)
  one-hot).
- ``score_sequences``: the M/I/D forward recursion in log space, float32,
  one step per residue over all rows at once (padding freezes a row). The
  delete chain of a step, D_j = logaddexp(u_j, D_{j-1} + c_j), is a
  first-order recurrence in the (logsumexp, +) semiring, solved by a
  doubling scan: log2(L) steps of an add and a logaddexp. (Not as
  C + logcumsumexp(u - C) with C = cumsum(c): C reaches ~-1e4 over a long
  profile, where float32 loses ~1e-3 per entry.)

Scores are log-odds against a background null model, so indel variants of
different lengths compare, as HMMER bit scores do.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from proteingym_tpu_torch.devices import resolve_device

AA_ORDER = "ACDEFGHIKLMNPQRSTVWY"
NEG_BIG = -1e30
TRANSITIONS = ("MM", "MI", "MD", "IM", "II", "DM", "DD")


@dataclasses.dataclass
class ProfileHMM:
    """Log-space parameters; L = number of match states (focus columns)."""

    log_e_match: np.ndarray  # (L, 20) match emission log-probs
    log_bg: np.ndarray  # (20,) background (insert emission and null model)
    log_a: dict  # MM, MI, MD, IM, II, DM, DD -> (L,) transition log-probs

    @property
    def L(self) -> int:
        return self.log_e_match.shape[0]


def build_profile_hmm(
    matrix: np.ndarray,
    weights: Optional[np.ndarray] = None,
    emission_pseudocount: float = 0.5,
    transition_pseudocount: float = 0.5,
    insert_open: float = 0.01,
    insert_extend: float = 0.4,
) -> ProfileHMM:
    """A profile HMM from an (N, L) focus-column matrix (0 = gap, 1..20 =
    amino acids in '-ACDEFGHIKLMNPQRSTVWY' order). Insert states take the
    fixed ``insert_open`` / ``insert_extend`` probabilities: the
    focus-column matrix holds no insert observations."""
    matrix = np.asarray(matrix)
    n, length = matrix.shape
    if weights is None:
        weights = np.ones(n)
    weights = np.asarray(weights, dtype=np.float64)

    aa = matrix.astype(np.int64) - 1
    rows, cols = np.nonzero(aa >= 0)
    counts = np.bincount(cols * 20 + aa[rows, cols], weights=weights[rows],
                         minlength=length * 20).reshape(length, 20)
    e_match = (counts + emission_pseudocount) / (
        counts.sum(axis=1, keepdims=True) + 20 * emission_pseudocount)
    bg_counts = counts.sum(axis=0)
    bg = (bg_counts + emission_pseudocount) / (bg_counts.sum() + 20 * emission_pseudocount)

    # M/D transition counts from the gap patterns of consecutive columns
    present = matrix > 0
    pc = transition_pseudocount
    w = weights[:, None]
    prev, nxt = present[:, :-1], present[:, 1:]
    c_mm = (w * (prev & nxt)).sum(axis=0)
    c_md = (w * (prev & ~nxt)).sum(axis=0)
    c_dm = (w * (~prev & nxt)).sum(axis=0)
    c_dd = (w * (~prev & ~nxt)).sum(axis=0)
    m_tot = c_mm + c_md + 2 * pc
    d_tot = c_dm + c_dd + 2 * pc
    a_md = np.concatenate([(c_md + pc) / m_tot, [1e-4]])  # the last column barely deletes
    a_dm = np.concatenate([(c_dm + pc) / d_tot, [1.0 - 1e-4]])
    a_dd = 1.0 - a_dm
    a_mi = np.full(length, insert_open)
    a_ii = np.full(length, insert_extend)
    a_im = 1.0 - a_ii
    a_mm = 1.0 - a_md - a_mi
    probs = dict(MM=a_mm, MI=a_mi, MD=a_md, IM=a_im, II=a_ii, DM=a_dm, DD=a_dd)
    with np.errstate(divide="ignore"):
        log_a = {k: np.log(v) for k, v in probs.items()}
    return ProfileHMM(log_e_match=np.log(e_match), log_bg=np.log(bg), log_a=log_a)


def _encode(seq: str) -> np.ndarray:
    """Canonical amino acids -> 0..19; degenerate residues (X, B, Z, U...)
    -> 20, emitted from the background (log-odds 0), as HMMER does; -1 is
    kept for padding, which freezes the recursion."""
    idx = {a: i for i, a in enumerate(AA_ORDER)}
    return np.asarray([idx.get(c.upper(), len(AA_ORDER)) for c in seq], dtype=np.int32)


def doubling_levels(c: torch.Tensor) -> List[torch.Tensor]:
    """The carries of ``delete_chain``'s levels: at offset s = 2^k, entry
    j >= s holds the sum of c over the s entries (j - s, j]. They are the
    same at every step of the recursion, so made once per profile."""
    levels, carry, s = [], c, 1
    while s < c.shape[-1]:
        levels.append(carry[s:])
        carry = torch.cat([carry[:s], carry[:-s] + carry[s:]])
        s *= 2
    return levels


def delete_chain(u: torch.Tensor, levels: List[torch.Tensor]) -> torch.Tensor:
    """D_j = logaddexp(u_j, D_{j-1} + c_j) along the last axis (D_0 = u_0),
    by a Hillis-Steele scan in the (logsumexp, +) semiring: at offset s,
    D_j <- logaddexp(D_j, D_{j-s} + C_j), where C_j sums c over the s
    entries (j-s, j]. ``levels`` comes from ``doubling_levels(c)``."""
    s = 1
    for carry in levels:
        u = torch.cat([u[..., :s], torch.logaddexp(u[..., s:], u[..., :-s] + carry)], dim=-1)
        s *= 2
    return u


@torch.no_grad()
def forward_logprob(
    hmm: ProfileHMM,
    tokens: torch.Tensor,
    insert_open: float = 0.01,
    insert_extend: float = 0.4,
) -> torch.Tensor:
    """Log-odds forward scores (log p(seq | HMM) - log p(seq | background))
    of (B, T) int token rows padded with -1, float32 (B,), on the tokens'
    device.

    States: BEGIN (before the first residue), I_0 (N-terminal inserts),
    and M_j / I_j / D_j for the model columns j = 1..L. Insert emissions
    equal the background, so their log-odds term is zero."""
    device = tokens.device
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    e_m, bg = f32(hmm.log_e_match), f32(hmm.log_bg)
    a = {k: f32(hmm.log_a[k]) for k in TRANSITIONS}
    b, length = tokens.shape[0], hmm.L
    # log-odds match emission per token code, (21, L); code 20 (degenerate)
    # is emitted from the background: 0
    emit_table = torch.cat([(e_m - bg[None, :]).T, torch.zeros(1, length, device=device)])

    log_i_open = float(np.log(insert_open))
    log_i_ext = float(np.log(insert_extend))
    log_i_exit = float(np.log(1.0 - insert_extend))
    b_d1 = a["MD"][0]  # BEGIN -> D_1
    b_m1 = torch.log(torch.clamp(1.0 - torch.exp(b_d1) - insert_open, min=1e-8))  # -> M_1
    neg = torch.full((b, 1), NEG_BIG, device=device)
    # the chain multiplier into column j is the DD transition out of column j-1
    levels = doubling_levels(torch.cat([torch.zeros(1, device=device), a["DD"][:-1]]))
    mm, im, dm, md = (a[k][:-1] for k in ("MM", "IM", "DM", "MD"))

    begin = torch.zeros(b, 1, device=device)
    ins0 = neg.clone()
    m = torch.full((b, length), NEG_BIG, device=device)
    i = m.clone()
    # deletes before any residue: BEGIN -> D_1 -> D_2 ...
    u0 = torch.full((1, length), NEG_BIG, device=device)
    u0[0, 0] = b_d1
    d = delete_chain(u0, levels).expand(b, length)
    codes = tokens.long().clamp(0, emit_table.shape[0] - 1)
    for t in range(tokens.shape[1]):
        is_pad = (tokens[:, t] < 0)[:, None]
        emit = emit_table[codes[:, t]]
        new_ins0 = torch.logaddexp(begin + log_i_open, ins0 + log_i_ext)
        entry_m1 = torch.logaddexp(begin + b_m1, ins0 + log_i_exit)
        prev_m = torch.cat([entry_m1, m[:, :-1] + mm], dim=1)
        prev_i = torch.cat([neg, i[:, :-1] + im], dim=1)
        prev_d = torch.cat([neg, d[:, :-1] + dm], dim=1)
        new_m = emit + torch.logaddexp(torch.logaddexp(prev_m, prev_i), prev_d)
        new_i = torch.logaddexp(m + a["MI"], i + a["II"])
        new_d = delete_chain(torch.cat([neg, new_m[:, :-1] + md], dim=1), levels)
        # BEGIN is unreachable once a residue is consumed
        begin = torch.where(is_pad, begin, NEG_BIG)
        ins0 = torch.where(is_pad, ins0, new_ins0)
        m = torch.where(is_pad, m, new_m)
        i = torch.where(is_pad, i, new_i)
        d = torch.where(is_pad, d, new_d)
    # termination: M_L / I_L / D_L -> END
    return torch.logaddexp(torch.logaddexp(m[:, -1], i[:, -1]), d[:, -1])


def score_sequences(hmm: ProfileHMM, sequences: Sequence[str], device="cuda") -> np.ndarray:
    """Log-odds forward scores of sequences of any lengths, float64 (N,):
    all rows in one batch, padded to the longest with -1."""
    device = resolve_device(device)
    toks = [_encode(s) for s in sequences]
    rows = np.full((len(toks), max(len(t) for t in toks)), -1, dtype=np.int32)
    for k, t in enumerate(toks):
        rows[k, :len(t)] = t
    out = forward_logprob(hmm, torch.from_numpy(rows).to(device))
    return out.double().cpu().numpy()
