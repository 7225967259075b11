"""RSALOR-class predictor (counterpart of proteingym_tpu/models/rsalor.py):
relative solvent accessibility x MSA log-odds.

The reference wraps the ``rsalor`` package (ref proteingym/baselines/
RSALOR/run_rsalor.py:1-116). Per substitution wt -> mt at i:

  LOR_i = log( f_i(mt) / f_i(wt) )     weighted MSA frequencies, pseudocounts
  score = (1 + gamma * (1 - RSA_i)) * LOR_i

RSA comes from a structure when one is given (a burial proxy: the CA count
within 10 A, normalised) and is 0.5 without one. The column counts are one
weighted ``bincount`` in float64 on ``device`` (msa/columns.py); the rest
is host work on (L, 20) tables.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from proteingym_tpu_torch.data.mutants import is_wt_row
from proteingym_tpu_torch.msa.columns import column_counts

AA20 = "ACDEFGHIKLMNPQRSTVWY"


def rsa_from_structure(coords: np.ndarray, radius: float = 10.0,
                       max_neighbors: int = 24) -> np.ndarray:
    """Burial-based RSA proxy in [0, 1]: 1 - neighbour density."""
    ca = coords[:, 1]
    d = np.linalg.norm(ca[:, None] - ca[None], axis=-1)
    counts = (d < radius).sum(1) - 1
    return np.clip(1.0 - counts / max_neighbors, 0.0, 1.0)


@dataclasses.dataclass
class RsalorModel:
    log_freq: np.ndarray  # (L, 20)
    rsa: np.ndarray  # (L,)
    gamma: float = 1.0
    alphabet: str = AA20


def fit_rsalor(
    matrix: np.ndarray,
    weights: Optional[np.ndarray] = None,
    coords: Optional[np.ndarray] = None,
    pseudocount: float = 0.5,
    gamma: float = 1.0,
    device="cuda",
) -> RsalorModel:
    counts = column_counts(matrix, weights, device=device) + pseudocount
    freq = counts / counts.sum(1, keepdims=True)
    rsa = rsa_from_structure(coords) if coords is not None else np.full(matrix.shape[1], 0.5)
    return RsalorModel(log_freq=np.log(freq), rsa=rsa, gamma=gamma)


def score_mutants(model: RsalorModel, wt_focus_seq: str, mutants: Sequence[str],
                  offset_idx: int = 1) -> np.ndarray:
    aa_idx = {a: i for i, a in enumerate(model.alphabet)}
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        for tok in m.split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if wt_focus_seq[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            lor = model.log_freq[pos, aa_idx[mt]] - model.log_freq[pos, aa_idx[wt]]
            out[i] += (1.0 + model.gamma * (1.0 - model.rsa[pos])) * lor
    return out
