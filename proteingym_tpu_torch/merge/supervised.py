"""Supervised score merging without pandas (counterpart of
proteingym_tpu/merge/supervised.py; the reference's merge_supervised.py:
10-139):

  - per CV scheme (fold_random_5 / fold_modulo_5 / fold_contiguous_5;
    indels: fold_random_5), a left join of every model's predictions onto
    the assay's rows by the model's merge key, models in registry order;
  - the first model's ``label_name`` column becomes ``normalized_targets``;
  - duplicate keys of a score file are averaged (pandas'
    ``groupby().mean()``: sorted keys, Kahan means);
  - a join that changes the assay's mutant set raises;
  - per (assay, model): Spearman of the predictions against the normalised
    targets over the rows where both are present, with average ranks (what
    pandas' ``corr(method="spearman")`` computes), and their MSE with NaN
    skipped; the long table (DMS_id, model_name, fold_variable_name,
    Spearman, MSE) sorted by its first three columns.

A cell pandas would read as a number is read as one (a column whose every
cell is a number or NA), so the merged files write the same values.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Callable, List, Optional, Sequence

import numpy as np

from proteingym_tpu_torch.data.reference import ReferenceSet
from proteingym_tpu_torch.data.registry import ModelEntry, ModelRegistry
from proteingym_tpu_torch.data.table import Table, parse_numeric, read_csv, write_csv
from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.metrics.aggregate import group_mean
from proteingym_tpu_torch.metrics.core import spearman

log = logging.getLogger(__name__)

CV_SCHEMES_SUBS = ["fold_random_5", "fold_modulo_5", "fold_contiguous_5"]
CV_SCHEMES_INDELS = ["fold_random_5"]
LONG_COLUMNS = ["DMS_id", "model_name", "fold_variable_name", "Spearman", "MSE"]


def read_csv_inferred(path) -> Table:
    """A CSV with each column numeric when every cell is a number or NA
    (int64 when every cell is an integer), as pandas infers it."""
    table = read_csv(path)
    for name in table.names:
        try:
            table[name] = parse_numeric(table[name])
        except ValueError:
            pass
    return table


def _pair_metrics(targets: np.ndarray, preds: np.ndarray, device):
    valid = ~(np.isnan(targets) | np.isnan(preds))
    rho = float(spearman(targets, preds, valid=valid, device=device))
    err = (targets - preds) ** 2
    live = err[~np.isnan(err)]
    mse = float(live.mean()) if len(live) else float("nan")
    return rho, mse


def _merge_model(merged: Table, scores: Table, entry: ModelEntry, dms_id: str) -> Table:
    key = entry.key
    pred_col = f"{entry.name}_predictions"
    columns = {pred_col: entry.input_score_name}
    if "normalized_targets" not in merged:
        if not entry.label_name or entry.label_name not in scores:
            raise KeyError(f"model {entry.name!r}: label_name {entry.label_name!r} not found in "
                           f"its score file (columns: {scores.names}) — the first merged model "
                           "must carry the CV target column")
        columns["normalized_targets"] = entry.label_name
    names = list(columns)
    values = np.stack([np.asarray(scores[src], dtype=np.float64) if scores[src].dtype != object
                       else parse_numeric(scores[src]).astype(np.float64)
                       for src in columns.values()], axis=1)
    groups, means = group_mean(values, [(k,) for k in scores[key].tolist()])
    row_of = {g[0]: i for i, g in enumerate(groups)}
    before = set(merged[key].tolist())
    at = np.asarray([row_of.get(k, -1) for k in merged[key].tolist()], dtype=np.int64)
    out = merged.select(merged.names)
    padded = np.vstack([means, np.full((1, len(names)), np.nan)])  # row -1: no match
    for j, name in enumerate(names):
        out[name] = padded[at, j]
    after = set(out[key].tolist())
    if len(after) != len(out) or after != before:
        raise ValueError(f"Merge on {entry.name} for {dms_id} changed the mutant set (ref "
                         "merge_supervised.py:108-111)")
    return out


def merge_supervised(
    reference: ReferenceSet,
    registry: ModelRegistry,
    dms_loader: Callable,
    score_loader: Callable[[str, str, ModelEntry], Optional[Table]],
    output_dir: Optional[str | Path] = None,
    mutation_type: str = "substitutions",
    cv_schemes: Optional[Sequence[str]] = None,
    device="cuda",
) -> Table:
    """Merge the supervised predictions and compute per-assay Spearman and
    MSE. ``score_loader(cv_scheme, DMS_id, entry)`` returns a model's table
    for one assay and scheme, or None. Returns the long table; with
    ``output_dir`` also writes ``<scheme>/<DMS_id>.csv`` and
    ``merged_scores_<mutation_type>_DMS.csv``. The Spearman of each pair runs
    in float64 on ``device``."""
    device = resolve_device(device)
    if cv_schemes is None:
        cv_schemes = CV_SCHEMES_INDELS if mutation_type == "indels" else CV_SCHEMES_SUBS
    output_dir = Path(output_dir) if output_dir is not None else None
    rows: List[tuple] = []
    for cv_scheme in cv_schemes:
        for rec in reference:
            dms_frame = dms_loader(rec)
            if dms_frame is None:
                log.warning("Could not find DMS file for %s; skipping", rec.DMS_id)
                continue
            merged = dms_frame.select(dms_frame.names)
            if "mutated_sequence" not in merged:
                merged["mutated_sequence"] = merged["mutant"]
            for entry in registry:
                scores = score_loader(cv_scheme, rec.DMS_id, entry)
                if scores is None:
                    log.warning("Missing %s scores for %s (%s)", entry.name, rec.DMS_id,
                                cv_scheme)
                    rows.append((rec.DMS_id, entry.name, cv_scheme, np.nan, np.nan))
                    continue
                merged = _merge_model(merged, scores, entry, rec.DMS_id)
                rows.append((rec.DMS_id, entry.name, cv_scheme,
                             *_pair_metrics(merged["normalized_targets"],
                                            merged[f"{entry.name}_predictions"], device)))
            if output_dir is not None:
                (output_dir / cv_scheme).mkdir(parents=True, exist_ok=True)
                write_csv(output_dir / cv_scheme / f"{rec.DMS_id}.csv", merged)
    rows.sort(key=lambda r: r[:3])
    long = Table(n_rows=len(rows))
    for j, name in enumerate(LONG_COLUMNS):
        col = [r[j] for r in rows]
        long[name] = (np.asarray(col, dtype=np.float64) if j >= 3
                      else np.asarray(col, dtype=object))
    if output_dir is not None:
        output_dir.mkdir(parents=True, exist_ok=True)
        write_csv(output_dir / f"merged_scores_{mutation_type}_DMS.csv", long)
    return long


def supervised_filesystem_loaders(dms_dir: str | Path, scores_root: str | Path):
    """The reference layout: ``scores_root/<cv_scheme>/<location>/<DMS_id>.csv``."""
    dms_dir, scores_root = Path(dms_dir), Path(scores_root)

    def dms_loader(rec):
        path = dms_dir / (rec.DMS_filename or f"{rec.DMS_id}.csv")
        return read_csv_inferred(path) if path.exists() else None

    def score_loader(cv_scheme: str, dms_id: str, entry: ModelEntry):
        path = scores_root / cv_scheme / entry.location / f"{dms_id}.csv"
        return read_csv_inferred(path) if path.exists() else None

    return dms_loader, score_loader
