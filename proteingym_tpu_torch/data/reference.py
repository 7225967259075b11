"""ProteinGym reference-file loader on the stdlib ``csv`` module
(counterpart of proteingym_tpu/data/reference.py for the fields the
``score`` path reads)."""

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
            seq_len=int(float(cell["seq_len"])) if "seq_len" in cell else len(target),
            raw=row,
        ))
    return ReferenceSet(records)
