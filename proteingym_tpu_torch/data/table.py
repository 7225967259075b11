"""Columnar CSV tables on the stdlib ``csv`` module and numpy, in place of
``pd.read_csv`` / ``to_csv`` for merge and evaluate.

A ``Table`` is an ordered dict of equal-length numpy columns. Numeric
columns are float64 (an empty or NA cell is NaN) or int64 (every cell an
integer literal, as pandas infers int64); the rest stay strings (object
arrays, ``None`` for an empty cell). Writing follows ``DataFrame.to_csv``:
floats as ``repr(float)``, NaN and ``None`` as the empty string, ints as
ints, so pandas reads a written file back to the same values.
"""

from __future__ import annotations

import csv
import html
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

# pandas' default NA strings (read_csv ``na_values``)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})
_INT_COLUMN = re.compile(r"[+-]?\d+(?:\n[+-]?\d+)*")


def parse_numeric(cells: Sequence) -> np.ndarray:
    """Strings -> int64 when every cell is an integer literal, else float64
    with NA strings as NaN."""
    cells = ["" if c is None else str(c).strip() for c in cells]
    if cells and _INT_COLUMN.fullmatch("\n".join(cells)):
        return np.asarray(cells, dtype=np.int64)
    return np.asarray(["nan" if c in NA_STRINGS else c for c in cells], dtype=np.float64)


class Table:
    """Ordered, equal-length numpy columns."""

    def __init__(self, columns: Optional[Dict[str, Iterable]] = None, n_rows: int = 0):
        self.columns: Dict[str, np.ndarray] = {}
        self._n = n_rows
        for name, values in (columns or {}).items():
            self[name] = values

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __setitem__(self, name: str, values) -> None:
        arr = np.asarray(values)
        if arr.dtype.kind in "USO":
            arr = np.asarray(values, dtype=object)
        if not self.columns:
            self._n = len(arr)
        elif len(arr) != self._n:
            raise ValueError(f"column {name!r} has {len(arr)} rows, the table {self._n}")
        self.columns[name] = arr

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    def floats(self, name: str) -> np.ndarray:
        """The column as float64 (string cells parsed, NA as NaN)."""
        col = self.columns[name]
        if col.dtype == object:
            col = parse_numeric(col)
        return col.astype(np.float64)

    def select(self, names: Sequence[str]) -> "Table":
        out = Table(n_rows=self._n)
        for name in names:
            out[name] = self.columns[name]
        return out


def read_csv(path, numeric: Iterable[str] = ()) -> Table:
    """Read a CSV with a header row; the ``numeric`` columns that exist are
    parsed (``parse_numeric``), the others stay strings."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = [r for r in reader if r]
    width = len(header)
    if set(map(len, rows)) - {width}:  # ragged rows: pad or cut to the header
        rows = [(r + [""] * width)[:width] for r in rows]
    cols = list(zip(*rows)) if rows else [()] * width
    numeric = set(numeric)
    table = Table(n_rows=len(rows))
    for name, cells in zip(header, cols):
        table[name] = (parse_numeric(cells) if name in numeric
                       else np.asarray([c if c != "" else None for c in cells], dtype=object))
    return table


def format_cell(value) -> str:
    if value is None:
        return ""
    if isinstance(value, (bool, np.bool_)):
        return str(bool(value))
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return "" if np.isnan(value) else repr(float(value))
    return str(value)


def format_column(col: np.ndarray) -> List[str]:
    """``format_cell`` of every cell, by the column's dtype."""
    if col.dtype.kind == "f":
        return ["" if v != v else repr(v) for v in col.tolist()]
    if col.dtype.kind in "iub":
        return [str(v) for v in col.tolist()]
    return [format_cell(v) for v in col.tolist()]


def _rows(table: Table, index: Optional[Sequence] = None) -> List[List[str]]:
    cols = [format_column(c) for c in table.columns.values()]
    if index is not None:
        cols = [[format_cell(v) for v in index]] + cols
    return list(zip(*cols)) if cols else [[] for _ in range(len(table))]


def write_csv(path, table: Table, index: Optional[Sequence] = None,
              index_label: str = "") -> None:
    """``DataFrame.to_csv``: with ``index``, a first column headed
    ``index_label``; lines end in ``\n``, as pandas writes them here."""
    header = ([index_label] if index is not None else []) + table.names
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow(header)
        writer.writerows(_rows(table, index))


def write_html(path, table: Table, index: Optional[Sequence] = None,
               index_label: str = "") -> None:
    """A plain ``<table>`` of the cells ``write_csv`` writes."""
    header = ([index_label] if index is not None else []) + table.names
    lines = ['<table border="1" class="dataframe">', "  <thead>", "    <tr>"]
    lines += [f"      <th>{html.escape(str(h))}</th>" for h in header]
    lines += ["    </tr>", "  </thead>", "  <tbody>"]
    for row in _rows(table, index):
        lines.append("    <tr>")
        lines += [f"      <td>{html.escape(c)}</td>" for c in row]
        lines.append("    </tr>")
    lines += ["  </tbody>", "</table>"]
    Path(path).write_text("\n".join(lines) + "\n")
