"""Mutant-string parsing and application (counterpart of
proteingym_tpu/data/mutants.py, numpy only).

ProteinGym encodes substitutions as colon-joined triplets like ``A1P:D2N``
(1-indexed by default).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# canonical 20-letter amino-acid vocabulary (proteingym_tpu/constants.py)
AA_VOCAB = "ACDEFGHIKLMNPQRSTVWY"
AA_TO_IDX = {aa: i for i, aa in enumerate(AA_VOCAB)}


def is_wt_row(mutant) -> bool:
    """True for assay rows that denote the wild type: empty/NaN cells and
    the literal ``WT`` label (scored 0)."""
    if mutant is None or (isinstance(mutant, float) and np.isnan(mutant)):
        return True
    s = str(mutant).strip()
    return not s or s.upper() == "WT"


def parse_mutant(mutant: str, delim: str = ":") -> List[Tuple[str, int, str]]:
    """Parse ``A1P:D2N`` into ``[("A", 1, "P"), ("D", 2, "N")]``; positions
    as written. WT rows parse to no mutations."""
    if is_wt_row(mutant):
        return []
    out = []
    for token in mutant.split(delim):
        if len(token) < 3:
            raise ValueError(f"Malformed mutation token: {token!r}")
        from_aa, pos_str, to_aa = token[0], token[1:-1], token[-1]
        try:
            pos = int(pos_str)
        except ValueError as e:
            raise ValueError(f"Malformed mutation position in {token!r}") from e
        out.append((from_aa, pos, to_aa))
    return out


def apply_mutant(
    focus_seq: str,
    mutant: str,
    start_idx: int = 1,
    aa_vocab: str = AA_VOCAB,
    delim: str = ":",
) -> str:
    """Apply a substitution triplet string to ``focus_seq``, checking the
    wild-type letter and that the target amino acid is in the vocabulary."""
    seq = list(focus_seq)
    for from_aa, pos, to_aa in parse_mutant(mutant, delim=delim):
        rel = pos - start_idx
        if rel < 0 or rel >= len(seq):
            raise ValueError(
                f"Mutation {from_aa}{pos}{to_aa} out of bounds for sequence of "
                f"length {len(seq)} (start_idx={start_idx})"
            )
        if seq[rel] != from_aa:
            raise ValueError(
                f"Invalid from_AA for mutation {from_aa}{pos}{to_aa}: sequence "
                f"has {seq[rel]!r} at relative position {rel}"
            )
        if to_aa not in aa_vocab:
            raise ValueError(f"Mutant to_AA not in vocabulary: {to_aa!r}")
        seq[rel] = to_aa
    return "".join(seq)


def mutations_to_arrays(
    mutants: Sequence[str],
    max_depth: int | None = None,
    start_idx: int = 1,
    delim: str = ":",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``(positions, from_idx, to_idx, valid_mask)``, each (num_mutants,
    depth): 0-indexed positions and 20-letter indices; padding slots have
    ``valid_mask == False`` and position 0."""
    parsed = [parse_mutant(m, delim=delim) for m in mutants]
    depth = max((len(p) for p in parsed), default=1)
    depth = max(depth, 1)  # all-WT batches still need one (masked) slot
    if max_depth is not None:
        depth = max(depth, max_depth)
    n = len(parsed)
    positions = np.zeros((n, depth), dtype=np.int32)
    from_idx = np.zeros((n, depth), dtype=np.int32)
    to_idx = np.zeros((n, depth), dtype=np.int32)
    valid = np.zeros((n, depth), dtype=bool)
    for i, muts in enumerate(parsed):
        for j, (f, pos, t) in enumerate(muts):
            positions[i, j] = pos - start_idx
            from_idx[i, j] = AA_TO_IDX.get(f, 0)
            to_idx[i, j] = AA_TO_IDX.get(t, 0)
            valid[i, j] = True
    return positions, from_idx, to_idx, valid
