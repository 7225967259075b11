"""ProteinGym reference-file loader on the stdlib ``csv`` module
(counterpart of proteingym_tpu/data/reference.py for the fields the
``score`` and alignment paths read)."""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional


@dataclasses.dataclass(frozen=True)
class AssayRecord:
    """One row of a DMS reference file. Cells are kept as the strings the
    file holds in ``raw``; empty cells read as absent."""

    DMS_id: str
    DMS_filename: str
    UniProt_ID: str
    target_seq: str
    seq_len: int
    MSA_filename: Optional[str] = None
    MSA_start: Optional[int] = None
    MSA_end: Optional[int] = None
    MSA_theta: Optional[float] = None
    weight_file_name: Optional[str] = None
    raw: Optional[dict] = dataclasses.field(default=None, repr=False, compare=False)


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


def _int(cell: str) -> int:
    return int(float(cell))  # "12" or "12.0", as pandas may have written it


def load_reference(path: str | Path) -> ReferenceSet:
    """Load a DMS or clinical reference CSV into typed records."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    records = []
    for row in rows:
        cell = {k: v for k, v in row.items() if v not in (None, "")}
        target = cell.get("target_seq", "")
        records.append(AssayRecord(
            DMS_id=cell.get("DMS_id") or cell.get("protein_id") or "",
            DMS_filename=cell.get("DMS_filename", ""),
            UniProt_ID=cell.get("UniProt_ID", ""),
            target_seq=target,
            seq_len=_int(cell["seq_len"]) if "seq_len" in cell else len(target),
            MSA_filename=cell.get("MSA_filename"),
            MSA_start=_int(cell["MSA_start"]) if "MSA_start" in cell else None,
            MSA_end=_int(cell["MSA_end"]) if "MSA_end" in cell else None,
            MSA_theta=float(cell["MSA_theta"]) if "MSA_theta" in cell else None,
            weight_file_name=cell.get("weight_file_name"),
            raw=row,
        ))
    return ReferenceSet(records)
