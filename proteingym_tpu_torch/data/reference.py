"""ProteinGym reference-file loader on the stdlib ``csv`` module
(counterpart of proteingym_tpu/data/reference.py: the fields that
scoring, alignment, merge and evaluate read)."""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

from proteingym_tpu_torch.data.table import NA_STRINGS


@dataclasses.dataclass(frozen=True)
class AssayRecord:
    """One row of a DMS or clinical reference file. Cells are kept as the
    strings the file holds in ``raw``; empty (NA) cells read as absent."""

    DMS_id: str
    DMS_filename: str
    UniProt_ID: str
    target_seq: str
    seq_len: int
    taxon: Optional[str] = None
    source_organism: Optional[str] = None
    includes_multiple_mutants: Optional[bool] = None
    DMS_total_number_mutants: Optional[int] = None
    DMS_binarization_cutoff: Optional[float] = None
    DMS_binarization_method: Optional[str] = None
    coarse_selection_type: Optional[str] = None
    selection_type: Optional[str] = None
    MSA_filename: Optional[str] = None
    MSA_start: Optional[int] = None
    MSA_end: Optional[int] = None
    MSA_theta: Optional[float] = None
    MSA_Neff_L_category: Optional[str] = None
    weight_file_name: Optional[str] = None
    raw: Optional[dict] = dataclasses.field(default=None, repr=False, compare=False)

    @property
    def region(self) -> tuple:
        """MSA-covered [start, end] region in 1-indexed DMS coordinates."""
        return (self.MSA_start, self.MSA_end)


class ReferenceSet:
    """Ordered assay records, indexed by ``DMS_id`` or by row number."""

    def __init__(self, records: List[AssayRecord]):
        self.records = records
        self._by_id: Dict[str, AssayRecord] = {r.DMS_id: r for r in records}

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self) -> Iterator[AssayRecord]:
        return iter(self.records)

    def __getitem__(self, key) -> AssayRecord:
        if isinstance(key, int):
            return self.records[key]
        return self._by_id[key]

    def __contains__(self, dms_id: str) -> bool:
        return dms_id in self._by_id

    @property
    def dms_ids(self) -> List[str]:
        return [r.DMS_id for r in self.records]

    def uniprot_lookup(self, column: str) -> List[Tuple[Optional[str], Optional[str]]]:
        """Distinct (UniProt_ID, ``column``) pairs in file order, read from
        the raw cells (empty cells as None)."""
        seen = {}
        for r in self.records:
            raw = r.raw or {}
            pair = tuple(None if raw.get(c) in NA_STRINGS else raw.get(c)
                         for c in ("UniProt_ID", column))
            if column == "MSA_Neff_L_category":
                pair = (pair[0], _norm_depth_category(pair[1]))
            seen.setdefault(pair, None)
        return list(seen)


def _int(cell: str) -> int:
    return int(float(cell))  # "12" or "12.0", as pandas may have written it


def _bool(cell: str) -> bool:
    low = cell.lower()
    if low in ("true", "false"):
        return low == "true"
    return bool(float(cell))


def _norm_depth_category(x):
    # the reference's quirk: first letter uppercased
    # (performance_DMS_benchmarks.py:128)
    if isinstance(x, str) and x:
        return x[0].upper() + x[1:]
    return x


def load_reference(path: str | Path) -> ReferenceSet:
    """Load a DMS or clinical reference CSV into typed records (a clinical
    file names its rows by ``protein_id`` and lacks some columns)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    casts = {"seq_len": _int, "includes_multiple_mutants": _bool,
             "DMS_total_number_mutants": _int, "DMS_binarization_cutoff": float,
             "MSA_start": _int, "MSA_end": _int, "MSA_theta": float,
             "MSA_Neff_L_category": _norm_depth_category}
    optional = [f.name for f in dataclasses.fields(AssayRecord)[5:-1]]
    records = []
    for row in rows:
        cell = {k: v for k, v in row.items() if v not in NA_STRINGS and v is not None}
        target = cell.get("target_seq", "")
        records.append(AssayRecord(
            DMS_id=cell.get("DMS_id") or cell.get("protein_id") or "",
            DMS_filename=cell.get("DMS_filename", ""),
            UniProt_ID=cell.get("UniProt_ID", ""),
            target_seq=target,
            seq_len=_int(cell["seq_len"]) if "seq_len" in cell else len(target),
            raw=row,
            **{k: casts.get(k, str)(cell[k]) for k in optional if k in cell},
        ))
    return ReferenceSet(records)
