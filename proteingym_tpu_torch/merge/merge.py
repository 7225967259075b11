"""Score merging without pandas: per assay, a left join of every model's
score file onto the assay's rows (counterpart of
proteingym_tpu/merge/merge.py, the reference's merge.py:17-115).

  - the model's column is directionality * input_score_name
  - a ``sequence`` column is read as ``mutated_sequence``
  - duplicate (key, score) rows are dropped, then scores are averaged per
    key (sorted keys, Kahan means, as pandas' ``groupby().mean()``)
  - a model whose keys do not overlap the assay's, or are a strict subset
    of them, is skipped with a warning
  - indel assays join on ``mutated_sequence``
  - the joined keys are distinct, so the join keeps the assay's rows and
    their order; a final row count other than DMS_total_number_mutants
    is warned about
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from proteingym_tpu_torch.data.reference import ReferenceSet
from proteingym_tpu_torch.data.registry import ModelEntry, ModelRegistry
from proteingym_tpu_torch.data.table import Table, parse_numeric, read_csv, write_csv
from proteingym_tpu_torch.metrics.aggregate import group_mean

log = logging.getLogger(__name__)
DMS_NUMERIC = ("DMS_score", "DMS_score_bin")


def _cell_key(value):
    """Hashable identity of a cell for ``drop_duplicates`` (NaN equals NaN)."""
    if isinstance(value, float) and math.isnan(value):
        return ("nan",)
    return value


def merge_assay_scores(
    dms_frame: Table,
    model_scores: Dict[str, Table],
    registry: ModelRegistry,
    mutation_type: str = "substitutions",
    dms_id: str = "",
    expected_num_mutants: Optional[int] = None,
) -> Table:
    """Merge per-model score tables into one wide table for a single assay."""
    merged = dms_frame.select(dms_frame.names)
    if "mutated_sequence" not in merged:
        merged["mutated_sequence"] = merged["mutant"]
    orig_len = len(merged)
    for entry in registry:
        scores = model_scores.get(entry.name)
        if scores is not None:
            merged = _merge_one(merged, scores, entry, mutation_type, dms_id)
    if expected_num_mutants is not None and len(merged) != expected_num_mutants:
        log.warning(
            "Insufficient mutants for %s: %d, expected %d (original DMS length %d)",
            dms_id, len(merged), expected_num_mutants, orig_len,
        )
    return merged


def _merge_one(merged: Table, scores: Table, entry: ModelEntry, mutation_type: str,
               dms_id: str) -> Table:
    key = entry.key
    dms_key = key if mutation_type == "substitutions" else "mutated_sequence"
    cols = dict(scores.columns)
    if "sequence" in cols:
        cols["mutated_sequence"] = cols["sequence"]
    if key not in cols or entry.input_score_name not in cols:
        log.warning("Model %s score file missing column(s) for %s", entry.name, dms_id)
        return merged
    raw = cols[entry.input_score_name]
    values = entry.directionality * (parse_numeric(raw) if raw.dtype == object else raw)
    key_list, value_list = cols[key].tolist(), values.tolist()
    if len(set(key_list)) == len(key_list):  # distinct keys: each mean is the score
        mean_of = {k: float(v) for k, v in zip(key_list, value_list) if k is not None}
    else:
        distinct = {}  # drop_duplicates: the first of equal (key, score) rows
        for k, v in zip(key_list, value_list):
            distinct.setdefault((k, _cell_key(v)), (k, v))
        groups, means = group_mean(
            np.asarray([v for _, v in distinct.values()], dtype=np.float64),
            [(k,) for k, _ in distinct.values()])
        mean_of = {g[0]: m for g, m in zip(groups, means[:, 0])}

    model_keys = set(mean_of)
    dms_keys = set(merged[dms_key].tolist())
    if not (model_keys & dms_keys):
        log.warning("No overlap on mutants for %s with model %s; skipping", dms_id, entry.name)
        return merged
    if model_keys < dms_keys:
        log.warning("%s and %s do not have the same mutants; skipping", entry.name, dms_id)
        return merged
    out = merged.select(merged.names)
    out[entry.name] = np.asarray([mean_of.get(k, np.nan) for k in merged[dms_key].tolist()],
                                 dtype=np.float64)
    return out


def merge_all(
    reference: ReferenceSet,
    registry: ModelRegistry,
    dms_loader: Callable,
    score_loader: Callable[[str, ModelEntry], Optional[Table]],
    output_dir: str | Path,
    mutation_type: str = "substitutions",
) -> None:
    """Merge every assay of the reference set into ``<DMS_id>.csv`` files.

    ``dms_loader(rec)`` takes an AssayRecord and returns the assay's table
    (mutant, mutated_sequence, DMS_score[, DMS_score_bin]);
    ``score_loader(DMS_id, entry)`` returns one model's score table."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for rec in reference:
        dms_frame = dms_loader(rec)
        if dms_frame is None:
            log.warning("Could not find DMS file for %s; skipping", rec.DMS_id)
            continue
        model_scores = {}
        for entry in registry:
            frame = score_loader(rec.DMS_id, entry)
            if frame is not None:
                model_scores[entry.name] = frame
        merged = merge_assay_scores(
            dms_frame, model_scores, registry, mutation_type=mutation_type,
            dms_id=rec.DMS_id, expected_num_mutants=rec.DMS_total_number_mutants,
        )
        write_csv(output_dir / f"{rec.DMS_id}.csv", merged)


def filesystem_loaders(dms_dir: str | Path, scores_root: str | Path):
    """Loaders for the reference layout: assay CSVs in ``dms_dir``, each
    model's scores in ``scores_root/<location>/<DMS_id>.csv``."""
    dms_dir = Path(dms_dir)
    scores_root = Path(scores_root)

    def dms_loader(rec):
        path = dms_dir / (rec.DMS_filename or f"{rec.DMS_id}.csv")
        return read_csv(path, numeric=DMS_NUMERIC) if path.exists() else None

    def score_loader(dms_id: str, entry: ModelEntry):
        path = scores_root / entry.location / f"{dms_id}.csv"
        return read_csv(path, numeric=(entry.input_score_name,)) if path.exists() else None

    return dms_loader, score_loader
