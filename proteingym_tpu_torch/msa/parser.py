"""A2M/A3M alignment parsing and EVE-style preprocessing, in numpy
(counterpart of proteingym_tpu/msa/parser.py, which the port cannot import:
that package's ``__init__`` loads its JAX weights module).

Behavioral parity target: ref proteingym/utils/msa_utils.py:24-205
(MSA_processing) — focus-column detection, fragment filtering, focus-column
gap thresholding, indeterminate-AA drops, and one-hot encoding — as array
transforms over an integer-encoded matrix. The alphabets come from the
shared, import-free ``proteingym_tpu.constants``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from proteingym_tpu.constants import (
    ALPHABET_PROTEIN_GAP,
    ALPHABET_PROTEIN_NOGAP,
    GAP,
)

# Integer codes for the preprocessing matrix: 0 = gap, 1..20 = amino acids,
# 21 = indeterminate/other (B, J, X, Z, O, U, ...). Lowercase letters are
# first mapped like their uppercase forms (the reference uppercases before
# filtering, msa_utils.py:170-171).
_CODE_GAP = 0
_CODE_OTHER = len(ALPHABET_PROTEIN_GAP)  # 21


def _build_code_table() -> np.ndarray:
    table = np.full(256, _CODE_OTHER, dtype=np.int8)
    for i, aa in enumerate(ALPHABET_PROTEIN_GAP):  # "-ACDE..."
        table[ord(aa)] = i
        table[ord(aa.lower())] = i
    table[ord(".")] = _CODE_GAP
    return table


_CODE_TABLE = _build_code_table()


def encode_alignment(sequences: List[str]) -> np.ndarray:
    """Vectorized char->code mapping: (N, L) int8 matrix."""
    lengths = {len(s) for s in sequences}
    if len(lengths) > 1:
        raise ValueError(
            "ragged alignment: sequences have lengths "
            f"{sorted(lengths)[:5]}… — align/pad rows to equal length "
            "first (raw A3M insertions must be removed or upper-cased)"
        )
    buf = np.frombuffer("".join(sequences).encode("latin-1"), dtype=np.uint8)
    return _CODE_TABLE[buf].reshape(len(sequences), -1)


@dataclasses.dataclass
class MSA:
    """A processed alignment restricted to focus columns.

    matrix: (N, L_focus) int8 over the gapped alphabet (0 = gap, 1..20 = AA).
            Indeterminate AAs never appear (those sequences are dropped,
            matching the reference default).
    """

    names: List[str]
    matrix: np.ndarray
    focus_seq_name: str
    focus_seq_trimmed: str
    focus_cols: np.ndarray
    focus_start: Optional[int] = None
    focus_stop: Optional[int] = None
    weights: Optional[np.ndarray] = None

    @property
    def num_sequences(self) -> int:
        return self.matrix.shape[0]

    @property
    def seq_len(self) -> int:
        return self.matrix.shape[1]

    @property
    def neff(self) -> float:
        if self.weights is None:
            return float(self.num_sequences)
        return float(np.sum(self.weights))

    def one_hot(self, dtype=np.float32) -> np.ndarray:
        """(N, L, 20) one-hot over the ungapped alphabet; gaps AND
        indeterminate codes (the force-kept focus row may contain X/B/Z/U,
        code 21) are all-zero rows (ref msa_utils.py:258-272: letters
        outside the alphabet get no one-hot channel)."""
        n, length = self.matrix.shape
        q = len(ALPHABET_PROTEIN_NOGAP)
        out = np.zeros((n, length, q), dtype=dtype)
        aa = self.matrix.astype(np.int32) - 1  # gap -> -1
        rows, cols = np.nonzero((aa >= 0) & (aa < q))
        out[rows, cols, aa[rows, cols]] = 1.0
        return out

    def sequences(self) -> List[str]:
        lut = np.frombuffer(
            (ALPHABET_PROTEIN_GAP + "X").encode("latin-1"), dtype=np.uint8
        )
        chars = lut[self.matrix.astype(np.int32)]
        return [bytes(row).decode("latin-1") for row in chars]


def parse_a2m(path_or_lines) -> Tuple[List[str], List[str], str]:
    """Parse FASTA/A2M text into (names, sequences, focus_seq_name).

    The first record is the focus sequence; its header is expected to look
    like ``>NAME/start-stop`` (ref msa_utils.py:42-46).
    """
    if isinstance(path_or_lines, (str, Path)):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    names: List[str] = []
    seqs: Dict[str, List[str]] = {}
    order: List[str] = []
    name = ""
    for line in lines:
        line = line.rstrip()
        if not line:
            continue
        if line.startswith(">"):
            name = line
            if name not in seqs:
                names.append(name)
                seqs[name] = []
                order.append(name)
        else:
            seqs[name].append(line)
    sequences = ["".join(seqs[n]) for n in order]
    focus_name = order[0] if order else ""
    return order, sequences, focus_name


def parse_focus_header(header: str) -> Tuple[Optional[int], Optional[int]]:
    """Extract (start, stop) from '>NAME/start-stop' headers."""
    try:
        span = header.split("/")[-1]
        start, stop = span.split("-")
        return int(start), int(stop)
    except (ValueError, IndexError):
        return None, None


def preprocess_msa(
    names: List[str],
    sequences: List[str],
    focus_seq_name: str,
    theta: float = 0.2,
    preprocess: bool = True,
    threshold_sequence_frac_gaps: float = 0.5,
    threshold_focus_cols_frac_gaps: float = 1.0,
    remove_sequences_with_indeterminate_AA_in_focus_cols: bool = True,
) -> MSA:
    """Apply the EVE preprocessing pipeline (ref msa_utils.py:102-205).

    Steps:
      1. drop alignment columns that are gaps in the focus (wild-type) sequence
      2. drop fragment sequences with > threshold fraction of gaps
      3. focus columns = remaining columns with gap fraction <= threshold
      4. restrict all sequences to focus columns, uppercased
      5. optionally drop sequences with indeterminate AAs in focus columns
    """
    focus_idx = names.index(focus_seq_name)
    raw = encode_alignment(sequences)  # (N, L_full)

    if preprocess:
        # 1. columns that are non-gap in the wild type
        wt_non_gap = raw[focus_idx] != _CODE_GAP
        mat = raw[:, wt_non_gap]
        # 2. fragment filter
        gaps = mat == _CODE_GAP
        seq_gap_frac = gaps.mean(axis=1)
        keep_seq = seq_gap_frac <= threshold_sequence_frac_gaps
        keep_seq[focus_idx] = True  # never drop the wild type
        # 3. focus columns from surviving sequences
        col_gap_frac = gaps[keep_seq].mean(axis=0)
        focus_cols_rel = col_gap_frac <= threshold_focus_cols_frac_gaps
        mat = mat[keep_seq][:, focus_cols_rel]
        kept_names = [n for n, k in zip(names, keep_seq) if k]
        # map focus cols back to original column indices
        orig_cols = np.nonzero(wt_non_gap)[0][focus_cols_rel]
    else:
        # focus columns = uppercase non-gap positions of the focus sequence
        focus_seq = sequences[focus_idx]
        focus_cols_mask = np.array(
            [c == c.upper() and c != GAP and c != "." for c in focus_seq]
        )
        mat = raw[:, focus_cols_mask]
        kept_names = list(names)
        orig_cols = np.nonzero(focus_cols_mask)[0]

    # 5. drop sequences with indeterminate AAs in focus columns
    if remove_sequences_with_indeterminate_AA_in_focus_cols:
        ok = ~(mat == _CODE_OTHER).any(axis=1)
        new_focus_idx = kept_names.index(focus_seq_name)
        ok[new_focus_idx] = True
        mat = mat[ok]
        kept_names = [n for n, k in zip(kept_names, ok) if k]
    else:
        # map indeterminate to gap so downstream kernels see a clean alphabet
        mat = np.where(mat == _CODE_OTHER, _CODE_GAP, mat)

    focus_row = kept_names.index(focus_seq_name)
    lut = np.frombuffer((ALPHABET_PROTEIN_GAP + "X").encode("latin-1"), dtype=np.uint8)
    focus_trimmed = bytes(lut[mat[focus_row].astype(np.int32)]).decode("latin-1")
    start, stop = parse_focus_header(focus_seq_name)
    return MSA(
        names=kept_names,
        matrix=mat.astype(np.int8),
        focus_seq_name=focus_seq_name,
        focus_seq_trimmed=focus_trimmed,
        focus_cols=orig_cols,
        focus_start=start,
        focus_stop=stop,
    )


def load_msa(path: str | Path, theta: float = 0.2, **kwargs) -> MSA:
    names, sequences, focus = parse_a2m(path)
    return preprocess_msa(names, sequences, focus, theta=theta, **kwargs)
