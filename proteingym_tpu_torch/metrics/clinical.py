"""Clinical benchmark evaluation without pandas: per-protein AUC and the
summary leaderboard (counterpart of proteingym_tpu/metrics/clinical.py).

  per protein: the ROC-AUC of every model column against the binary
  clinical label, all columns in one call on the device -> protein x model
  table -> mean over proteins -> bootstrap SE (protein resampling, centred
  on the top model)
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from proteingym_tpu_torch.data.reference import ReferenceSet
from proteingym_tpu_torch.data.registry import ModelRegistry
from proteingym_tpu_torch.data.table import Table, write_csv, write_html as write_table_html
from proteingym_tpu_torch.metrics.aggregate import column_mean, first_argmax, order_descending
from proteingym_tpu_torch.metrics.bootstrap import bootstrap_standard_error
from proteingym_tpu_torch.metrics.core import auc

LABEL_CANDIDATES = ["DMS_bin_score", "DMS_score_bin", "label", "ClinVar_label"]


def _find_label_column(frame: Table, label_column: Optional[str]) -> str:
    if label_column is not None:
        return label_column
    for cand in LABEL_CANDIDATES:
        if cand in frame:
            return cand
    raise KeyError(f"No clinical label column found (looked for {LABEL_CANDIDATES})")


def protein_aucs(merged: Table, model_names, label_column: Optional[str] = None,
                 device="cpu") -> Dict[str, float]:
    """{model: AUC} of one protein, every present model column in one
    batched call on ``device``: valid rows have a finite score and label,
    labels are truncated to int; NaN for a missing column, no valid row
    or a single class."""
    labels = merged.floats(_find_label_column(merged, label_column))
    present = [m for m in model_names if m in merged]
    out = {m: np.nan for m in model_names}
    if not present:
        return out
    scores = np.stack([merged.floats(m) for m in present])
    valid = np.isfinite(scores) & np.isfinite(labels)[None, :]
    y = np.trunc(np.where(np.isfinite(labels), labels, 0.0))
    vals = auc(torch.as_tensor(y, device=device).expand(len(present), -1),
               np.where(valid, scores, 0.0), valid, device=device).cpu().numpy()
    for m, v, ok in zip(present, vals, valid):
        if ok.any() and len(np.unique(y[ok])) >= 2:
            out[m] = float(v)
    return out


def evaluate_clinical(
    reference: ReferenceSet,
    registry: ModelRegistry,
    merged_scores_loader: Callable[[str], Optional[Table]],
    output_dir: str | Path,
    mutation_type: str = "substitutions",
    label_column: Optional[str] = None,
    bootstrap_samples: int = 10000,
    model_types: Optional[Dict[str, str]] = None,
    write_html: bool = False,
    device="cpu",
) -> Table:
    """AUC-only clinical evaluation, the AUCs on ``device``; writes
    ``AUC/clinical_<type>_AUC_DMS_level.csv`` and the summary. Returns the
    ranked summary."""
    output_dir = Path(output_dir) / "AUC"
    output_dir.mkdir(parents=True, exist_ok=True)
    model_names = registry.names
    rows: Dict[str, Dict[str, float]] = {}
    for rec in reference:
        merged = merged_scores_loader(rec.DMS_id)
        if merged is None:
            print(f"Scoring file for {rec.DMS_id} missing")
            continue
        rows[rec.DMS_id] = protein_aucs(merged, model_names, label_column, device=device)
    ids = list(rows)
    dms_level = Table(n_rows=len(ids))
    for m in model_names:
        dms_level[registry.clean_names.get(m, m)] = np.asarray(
            [rows[i][m] for i in ids], dtype=np.float64)
    rounded = Table({c: np.round(dms_level[c], 3) for c in dms_level.names}, n_rows=len(ids))
    write_csv(output_dir / f"clinical_{mutation_type}_AUC_DMS_level.csv", rounded, index=ids,
              index_label="RefSeq ID")
    return summarize_clinical(dms_level, output_dir=output_dir, mutation_type=mutation_type,
                              bootstrap_samples=bootstrap_samples, model_types=model_types,
                              write_html=write_html)


def summarize_clinical(
    dms_level: Table,
    output_dir: Optional[Path] = None,
    mutation_type: str = "substitutions",
    bootstrap_samples: int = 10000,
    model_types: Optional[Dict[str, str]] = None,
    write_html: bool = False,
) -> Table:
    """Protein-level AUC table (one column per model) -> ranked leaderboard:
    mean over proteins, bootstrap SE centred on the top model, 3-decimal
    rounding. Returns ``Model_rank`` (1..n) and the written columns."""
    names = dms_level.names
    values = np.stack([dms_level.floats(c) for c in names], axis=1) if names else np.zeros((0, 0))
    averages = column_mean(values)
    top = first_argmax(averages)
    se = bootstrap_standard_error(values - values[:, [top]],
                                  number_assay_reshuffle=bootstrap_samples)
    order = order_descending(averages)
    summary = Table(n_rows=len(names))
    summary["Model_name"] = np.asarray([names[i] for i in order], dtype=object)
    summary["Model type"] = np.asarray([(model_types or {}).get(names[i], "") for i in order],
                                       dtype=object)
    summary["Average_AUC"] = np.round(averages[order], 3)
    summary["Bootstrap_standard_error_AUC"] = np.round(se[order], 3)
    ranks = list(range(1, len(names) + 1))
    if output_dir is not None:
        out = Path(output_dir) / f"Summary_performance_clinical_{mutation_type}_AUC.csv"
        write_csv(out, summary, index=ranks, index_label="Model_rank")
        if write_html:
            write_table_html(out.with_suffix(".html"), summary, index=ranks,
                             index_label="Model_rank")
    result = Table({"Model_rank": np.asarray(ranks, dtype=np.int64)}, n_rows=len(names))
    for c in summary.names:
        result[c] = summary[c]
    return result
