"""Raw DMS assay cleanup into the canonical (mutant, mutated_sequence,
DMS_score) form, without pandas (counterpart of
proteingym_tpu/data/cleanup.py; ref proteingym/utils/data_utils.py:5-30).

The same steps and quirks as the JAX function's pandas code: null mutants
(pandas' NA strings) and malformed / out-of-range / WT-mismatched triplets
are dropped, with the reference's upper bound ``pos <= end_idx``; the
phenotype is coerced to a number (``to_numeric(errors="coerce")``: a cell
that is not a number becomes NaN) and non-finite rows are dropped; the
score is flipped by ``directionality``; duplicate mutants (silent-mutation
variants) are averaged as ``groupby("mutant").mean()`` does: sorted keys,
Kahan-compensated means in row order (``metrics.aggregate.group_mean``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from proteingym_tpu_torch.constants import AA_VOCAB
from proteingym_tpu_torch.data.mutants import apply_mutant
from proteingym_tpu_torch.data.table import NA_STRINGS, Table, read_csv
from proteingym_tpu_torch.metrics.aggregate import group_mean


def _valid_token(tok: str, target_seq: str, start_idx: int, end_idx: int) -> bool:
    if len(tok) < 3:
        return False
    wt, pos_str, mt = tok[0], tok[1:-1], tok[-1]
    if wt not in AA_VOCAB or mt not in AA_VOCAB or not pos_str.isnumeric():
        return False
    pos = int(pos_str)
    # ref quirk (data_utils.py:17): lower bound checks pos-start_idx >= 0 but
    # upper bound checks pos <= end_idx (not pos-start_idx < len).
    if pos - start_idx < 0 or pos > end_idx:
        return False
    return wt == target_seq[pos - start_idx]


def _is_null(cell) -> bool:
    return cell is None or (isinstance(cell, float) and np.isnan(cell)) or \
        (isinstance(cell, str) and cell in NA_STRINGS)


def _to_number(cell) -> float:
    """``pd.to_numeric(errors="coerce")`` of one cell: NaN for a null or a
    cell that is not a number."""
    if _is_null(cell):
        return np.nan
    if isinstance(cell, (int, float, np.integer, np.floating)):
        return float(cell)
    text = str(cell).strip()
    if "_" in text:  # Python's float() reads digit separators, pandas does not
        return np.nan
    try:
        return float(text)
    except ValueError:
        return np.nan


def dms_file_cleanup(
    dms_file: str | Path | Table,
    target_seq: str,
    start_idx: int = 1,
    end_idx: Optional[int] = None,
    mutant_column: str = "mutant",
    phenotype_name: str = "score",
    directionality: int = 1,
) -> Table:
    """Clean a raw substitution assay (a CSV path or a ``Table``) into a
    ``Table`` of (mutant, mutated_sequence, DMS_score).

    Steps (matching ref data_utils.py:5-30):
      1. drop null mutants and malformed / out-of-range / WT-mismatched triplets
      2. coerce the phenotype to numeric, drop non-finite rows
      3. DMS_score = phenotype * directionality (so higher = fitter)
      4. aggregate duplicate mutants (silent-mutation variants) by mean
      5. derive mutated_sequence from the target sequence
    """
    data = dms_file if isinstance(dms_file, Table) else read_csv(dms_file)
    end_idx = start_idx + len(target_seq) - 1 if end_idx is None else end_idx

    mutants, scores = [], []
    for m, raw in zip(data[mutant_column].tolist(), data[phenotype_name].tolist()):
        if _is_null(m):
            continue
        if not all(_valid_token(tok, target_seq, start_idx, end_idx)
                   for tok in str(m).split(":")):
            continue
        value = _to_number(raw)
        if not np.isfinite(value):
            continue
        mutants.append(str(m))
        scores.append(value * directionality)

    names, means = [], np.zeros(0)
    if mutants:
        keys, grouped = group_mean(np.asarray(scores, dtype=np.float64), [(m,) for m in mutants])
        names, means = [k[0] for k in keys], grouped[:, 0]
    return Table({
        "mutant": np.asarray(names, dtype=object),
        "mutated_sequence": np.asarray(
            [apply_mutant(target_seq, m, start_idx=start_idx) for m in names], dtype=object),
        "DMS_score": means,
    })
