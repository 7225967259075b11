"""Benchmark evaluation without pandas: merged scores -> DMS level ->
UniProt -> function -> summary (counterpart of
proteingym_tpu/metrics/aggregate.py, same artifacts, headers, row order
and values).

  per-assay metrics (5 metrics x models [x mutation-depth splits]), all
  columns of one assay in one batched call on the device
    -> (assay x model) DMS-level CSV, rounded to 3 decimals
    -> UniProt means, (UniProt, selection type) means, function means
    -> bootstrap SE centred on the top model
    -> splits by MSA depth / taxon / function / mutation depth
    -> ranked Summary_performance_<...>.csv

The pandas semantics are reproduced where they decide a value: ``round(3)``
is numpy's ``rint(x * 1000) / 1000`` and happens before the UniProt
aggregation (the reference's quirk); ``groupby`` sorts its keys, drops
missing ones and takes Kahan-compensated means in row order;
``DataFrame.mean`` skips NaN over a pairwise (numpy) sum; the left merge
with the distinct (UniProt, selection type) pairs repeats a UniProt that
has two selection types, and the UniProt-level average counts it twice;
``idxmax`` takes the first maximum; ``sort_values`` descending keeps ties
in order and puts NaN last.
"""

from __future__ import annotations

import csv
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteingym_tpu_torch.constants import METRICS, MUTATION_DEPTHS
from proteingym_tpu_torch.data.reference import ReferenceSet
from proteingym_tpu_torch.data.registry import ModelRegistry, registry_from_dict
from proteingym_tpu_torch.data.table import Table, format_cell, read_csv, write_csv
from proteingym_tpu_torch.data.table import write_html as write_table_html
from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.metrics.bootstrap import (
    bootstrap_standard_error_functional_categories,
)
from proteingym_tpu_torch.metrics.core import batched_assay_metrics, metrics_to_numpy

META = ("UniProt_ID", "Selection Type", "MSA_Neff_L_category", "Taxon")
MSA_DEPTH_COLUMNS = {"Low": "Low_MSA_depth", "Medium": "Medium_MSA_depth",
                     "High": "High_MSA_depth"}
TAXON_COLUMNS = {"Human": "Taxa_Human", "Eukaryote": "Taxa_Other_Eukaryote",
                 "Prokaryote": "Taxa_Prokaryote", "Virus": "Taxa_Virus"}
FUNCTION_COLUMNS = ["Function_Activity", "Function_Binding", "Function_Expression",
                    "Function_OrganismalFitness", "Function_Stability"]
# columns of one assay's metric batch: bounds the (columns x rows) tensors
MAX_BATCH_ELEMENTS = 1 << 24


def _depth_group(mutant: str) -> str:
    d = len(mutant.split(":"))
    return "5+" if d >= 5 else str(d)


def _is_depth_column(name: str) -> bool:
    return name.split("_")[-1] in MUTATION_DEPTHS


def _round3(x):
    return np.round(np.asarray(x, dtype=np.float64), 3)


# ---------------------------------------------------------------------------
# pandas reductions, reproduced
# ---------------------------------------------------------------------------

def group_mean(values: np.ndarray, keys: Sequence[tuple]) -> Tuple[List[tuple], np.ndarray]:
    """``groupby(keys).mean()`` of the (n, K) values: sorted distinct keys
    (rows with a missing key part left out) and Kahan-compensated NaN-
    skipping means in row order, as pandas' ``group_mean`` takes them."""
    values = np.asarray(values, dtype=np.float64).reshape(len(keys), -1)
    uniq = sorted({k for k in keys if None not in k})
    index = {k: i for i, k in enumerate(uniq)}
    label = np.asarray([index.get(k, -1) for k in keys], dtype=np.int64)
    order = np.flatnonzero(label >= 0)
    order = order[np.argsort(label[order], kind="stable")]  # grouped, row order kept
    lab = label[order]
    rank = np.arange(len(order)) - np.searchsorted(lab, lab)  # place within the group
    width = values.shape[1]
    sumx, comp, nobs = (np.zeros((len(uniq), width)) for _ in range(3))
    # the k-th rows of all groups at once: the recurrence runs in row order
    # within each group, vectorised across groups
    for k in range(int(rank.max()) + 1 if len(rank) else 0):
        g = lab[rank == k]
        row = values[order[rank == k]]
        ok = ~np.isnan(row)
        y = row - comp[g]
        t = sumx[g] + y
        c = (t - sumx[g]) - y
        comp[g] = np.where(ok, np.where(np.isnan(c), 0.0, c), comp[g])
        sumx[g] = np.where(ok, t, sumx[g])
        nobs[g] += ok
    with np.errstate(invalid="ignore", divide="ignore"):
        return uniq, np.where(nobs > 0, sumx / np.maximum(nobs, 1), np.nan)


def column_mean(values: np.ndarray) -> np.ndarray:
    """``DataFrame.mean(numeric_only=True)`` of (n, K) values: per column,
    NaN filled with 0, numpy's pairwise sum, divided by the count."""
    values = np.asarray(values, dtype=np.float64)
    out = np.full(values.shape[1], np.nan)
    for j in range(values.shape[1]):
        col = values[:, j]
        ok = ~np.isnan(col)
        if ok.any():
            out[j] = np.ascontiguousarray(np.where(ok, col, 0.0)).sum() / ok.sum()
    return out


def first_argmax(values: np.ndarray) -> int:
    """``idxmax``: the first maximum, NaN skipped."""
    values = np.asarray(values, dtype=np.float64)
    if np.isnan(values).all():
        raise ValueError("Encountered all NA values")
    return int(np.nanargmax(values))


def order_descending(values: np.ndarray) -> np.ndarray:
    """``sort_values(ascending=False)``: ties keep their order, NaN last."""
    values = np.asarray(values, dtype=np.float64)
    live = np.flatnonzero(~np.isnan(values))
    live = live[np.argsort(-values[live], kind="stable")]
    return np.concatenate([live, np.flatnonzero(np.isnan(values))])


# ---------------------------------------------------------------------------
# per-assay metrics
# ---------------------------------------------------------------------------

def compute_assay_table(
    merged: Table,
    model_names: List[str],
    performance_by_depth: bool = False,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """All metrics of every model column of one merged-scores table:
    {metric: {label: value}}, labels the model names (plus ``model_depth``
    when splitting by mutation depth). Every column and depth split is a
    row of one ``batched_assay_metrics`` call on ``device``, valid where
    the score is finite (and the depth matches); a missing model column,
    or one with no valid row, gives NaN."""
    device = resolve_device(device)
    n = len(merged)
    y_true = merged.floats("DMS_score")
    y_bin = merged.floats("DMS_score_bin") if "DMS_score_bin" in merged else np.full(n, np.nan)
    splits = [("", np.ones(n, dtype=bool))]
    if performance_by_depth:
        depth = np.asarray([_depth_group(m) for m in merged["mutant"]], dtype=object)
        splits += [(f"_{d}", depth == d) for d in MUTATION_DEPTHS]
    out = {m: {model + suffix: np.nan for model in model_names for suffix, _ in splits}
           for m in METRICS}
    labels, scores, valid = [], [], []
    for model in model_names:
        if model not in merged:
            continue
        s = merged.floats(model)
        for suffix, sel in splits:
            labels.append(model + suffix)
            scores.append(s)
            valid.append(sel & np.isfinite(s))
    if not labels:
        return out
    scores, valid = np.stack(scores), np.stack(valid)
    y_true_d = torch.as_tensor(y_true, dtype=torch.float64, device=device)
    y_bin_d = torch.as_tensor(y_bin, dtype=torch.float64, device=device)
    step = max(1, MAX_BATCH_ELEMENTS // max(n, 1))
    parts = []
    for lo in range(0, len(labels), step):
        rows = slice(lo, lo + step)
        b = valid[rows].shape[0]
        parts.append(metrics_to_numpy(batched_assay_metrics(
            y_true_d.expand(b, n), y_bin_d.expand(b, n), scores[rows], valid[rows],
            device=device)))
    empty = ~valid.any(axis=1)
    for m in METRICS:
        col = np.concatenate([p[m] for p in parts])
        col[empty] = np.nan
        out[m].update(zip(labels, col.tolist()))
    return out


# ---------------------------------------------------------------------------
# the benchmark
# ---------------------------------------------------------------------------

def evaluate_benchmark(
    reference: ReferenceSet,
    registry: ModelRegistry,
    merged_scores_loader: Callable[[str], Optional[Table]],
    output_dir: str | Path,
    indel_mode: bool = False,
    performance_by_depth: bool = True,
    model_types: Optional[Dict[str, str]] = None,
    bootstrap_samples: int = 10000,
    seed: int = 0,
    write_html: bool = True,
    device="cuda",
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, Table]:
    """The metric and aggregation pipeline, writing every artifact of the
    JAX package's ``evaluate_benchmark``; the per-assay metrics run on
    ``device``. ``merged_scores_loader(DMS_id)`` returns the merged table
    or None (the assay is skipped). ``timings``, when given, gathers the
    seconds spent in ``io`` (loading and writing), ``metrics`` and
    ``bootstrap``. Returns {metric: summary table}."""
    device = resolve_device(device)
    clock = timings if timings is not None else {}
    for k in ("io", "metrics", "bootstrap"):
        clock.setdefault(k, 0.0)
    output_dir = Path(output_dir)
    if indel_mode:
        performance_by_depth = False
    model_names = registry.names
    mutation_type = "indels" if indel_mode else "substitutions"
    for metric in METRICS:
        (output_dir / metric).mkdir(parents=True, exist_ok=True)

    per_metric: Dict[str, Dict[str, Dict[str, float]]] = {m: {} for m in METRICS}
    meta_rows: Dict[str, dict] = {}
    for rec in reference:
        t0 = time.perf_counter()
        merged = merged_scores_loader(rec.DMS_id)
        clock["io"] += time.perf_counter() - t0
        if merged is None:
            print(f"Scoring file for {rec.DMS_id} missing")
            continue
        if "mutant" not in merged and "mutated_sequence" in merged:
            merged["mutant"] = merged["mutated_sequence"]
        t0 = time.perf_counter()
        table = compute_assay_table(merged, model_names,
                                    performance_by_depth=performance_by_depth, device=device)
        clock["metrics"] += time.perf_counter() - t0
        for m in METRICS:
            per_metric[m][rec.DMS_id] = table[m]
        meta_rows[rec.DMS_id] = {
            "number_mutants": len(merged),
            "UniProt_ID": rec.UniProt_ID,
            "Selection Type": rec.coarse_selection_type,
            "MSA_Neff_L_category": rec.MSA_Neff_L_category,
            "Taxon": rec.taxon,
        }

    dms_ids = list(meta_rows)
    summaries: Dict[str, Table] = {}
    for metric in METRICS:
        filename = f"DMS_{mutation_type}_{metric}"
        labels = list(dict.fromkeys(k for d in per_metric[metric].values() for k in d))
        frame = Table(n_rows=len(dms_ids))
        for label in labels:
            frame[label] = _round3([per_metric[metric][i].get(label, np.nan) for i in dms_ids])
        frame["number_mutants"] = np.asarray(
            [meta_rows[i]["number_mutants"] for i in dms_ids], dtype=np.int64)
        for c in META:
            frame[c] = np.asarray([meta_rows[i][c] for i in dms_ids], dtype=object)

        t0 = time.perf_counter()
        names = [c for c in frame.names if not (performance_by_depth and _is_depth_column(c))]
        dms_out = Table({registry.clean_name(c): frame[c] for c in names}, n_rows=len(dms_ids))
        write_csv(output_dir / metric / f"{filename}_DMS_level.csv", dms_out, index=dms_ids,
                  index_label="DMS ID")
        if write_html:
            write_table_html(output_dir / metric / f"{filename}_DMS_level.html", dms_out,
                             index=dms_ids)
        clock["io"] += time.perf_counter() - t0

        summaries[metric] = summarize_dms_level(
            frame, metric=metric, registry=registry,
            performance_by_depth=performance_by_depth,
            bootstrap_samples=bootstrap_samples, seed=seed, output_dir=output_dir,
            filename=filename, write_html=write_html, model_types=model_types,
            timings=clock,
        )
    return summaries


def summarize_dms_level(
    frame: Table,
    metric: str,
    registry: Optional[ModelRegistry] = None,
    performance_by_depth: bool = True,
    bootstrap_samples: int = 10000,
    seed: int = 0,
    output_dir: Optional[Path] = None,
    filename: Optional[str] = None,
    write_html: bool = False,
    model_types: Optional[Dict[str, str]] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Table:
    """The aggregation hierarchy from a per-assay metric table to the
    Summary_performance leaderboard (reference performance_DMS_benchmarks
    .py:296-403). ``frame`` has the schema of the ``*_DMS_level.csv``
    files: one numeric column per model (and per model and depth), then
    number_mutants, UniProt_ID, Selection Type, MSA_Neff_L_category and
    Taxon. Returns the summary: ``Model_rank`` (1..n) first, then the
    written columns."""
    clock = timings if timings is not None else {}
    if "number_mutants" not in frame:
        frame["number_mutants"] = np.zeros(len(frame), dtype=np.int64)
    all_columns = frame.names
    not_depth = [c for c in all_columns if not _is_depth_column(c)]
    base_cols = [c for c in not_depth if c not in ("number_mutants",) + META]
    if registry is None:
        registry = registry_from_dict({m: {"input_score_name": m} for m in base_cols})
    filename = filename or f"DMS_substitutions_{metric}"

    numeric = [c for c in all_columns if frame[c].dtype != object]
    values = np.stack([frame.floats(c) for c in numeric], axis=1)
    col = {c: j for j, c in enumerate(numeric)}
    scored = [c for c in numeric if c != "number_mutants"]  # model and depth columns
    sj = [col[c] for c in scored]
    uni, sel = list(frame["UniProt_ID"]), list(frame["Selection Type"])
    neff, taxon = list(frame["MSA_Neff_L_category"]), list(frame["Taxon"])

    # per-UniProt metadata: the first row of each UniProt
    first: Dict[object, int] = {}
    for i, u in enumerate(uni):
        first.setdefault(u, i)
    pairs = list(dict.fromkeys(zip(uni, sel)))  # distinct (UniProt, selection type)

    # ---- aggregation hierarchy ------------------------------------------
    u_keys, u_mean = group_mean(values, [(u,) for u in uni])
    uf_keys, uf_mean = group_mean(values[:, sj], list(zip(uni, sel)))
    up_rows = [(g, s) for g, (u,) in enumerate(u_keys) for (pu, s) in pairs if pu == u]
    up_vals = np.asarray([u_mean[g][sj] for g, _ in up_rows]).reshape(len(up_rows), len(sj))
    up_meta = {
        "UniProt_ID": [u_keys[g][0] for g, _ in up_rows],
        "MSA_Neff_L_category": [neff[first[u_keys[g][0]]] for g, _ in up_rows],
        "Taxon": [taxon[first[u_keys[g][0]]] for g, _ in up_rows],
        "Selection Type": [s for _, s in up_rows],
    }
    uniprot_average = column_mean(up_vals)
    f_keys, f_mean = group_mean(uf_mean, [(s,) for _, s in uf_keys])
    functions = [k[0] for k in f_keys]
    final_average = column_mean(f_mean)

    if performance_by_depth:
        top = base_cols[first_argmax([final_average[scored.index(c)] for c in base_cols])]
    else:
        top = scored[first_argmax(final_average)]
    t0 = time.perf_counter()
    se = bootstrap_standard_error_functional_categories(
        uf_mean - uf_mean[:, [scored.index(top)]], [s for _, s in uf_keys],
        number_assay_reshuffle=bootstrap_samples, seed=seed)
    clock["bootstrap"] = clock.get("bootstrap", 0.0) + time.perf_counter() - t0
    se_of = dict(zip(scored, se))

    up_table = _round3(np.vstack([up_vals, uniprot_average[None, :]]))
    f_table = _round3(np.vstack([f_mean, final_average[None, :]]))
    n_up = len(up_rows) + 1

    t0 = time.perf_counter()
    if output_dir is not None:
        out = Table(n_rows=n_up)
        if performance_by_depth:
            for c in not_depth:
                if c == "number_mutants":
                    continue
                out[c] = (up_table[:, scored.index(c)] if c in scored
                          else np.asarray(up_meta[c] + [None], dtype=object))
        else:
            out["UniProt_ID"] = np.asarray(up_meta["UniProt_ID"] + [None], dtype=object)
            for j, c in enumerate(scored):
                out[c] = up_table[:, j]
            for c in ("MSA_Neff_L_category", "Taxon", "Selection Type"):
                out[c] = np.asarray(up_meta[c] + [None], dtype=object)
        write_csv(output_dir / metric / f"{filename}_Uniprot_level.csv", out)

        func_cols = ([c for c in not_depth if c in base_cols or c == "Selection Type"]
                     + ["Selection Type"]) if performance_by_depth else ["Selection Type"] + scored
        header, cols = [], []
        for c in func_cols:
            header.append(c)
            cols.append(f_table[:, scored.index(c)] if c in scored
                        else np.asarray(functions + [None], dtype=object))
        _write_columns(output_dir / metric / f"{filename}_Uniprot_Selection_Type_level.csv",
                       header, cols)
    clock["io"] = clock.get("io", 0.0) + time.perf_counter() - t0

    # ---- split tables ----------------------------------------------------
    split_cols = [c for c in not_depth if c not in META] if performance_by_depth else numeric
    split_j = [col[c] for c in split_cols]

    def split(keys, names):
        pk, pm = group_mean(values, [(u, k) for u, k in zip(uni, keys)])
        ck, cm = group_mean(pm, [(k,) for _, k in pk])
        at = {k[0]: i for i, k in enumerate(ck)}
        return {name: np.asarray([cm[at[cat], j] if cat in at else np.nan for j in split_j])
                for cat, name in names.items()}

    by_msa = split(neff, MSA_DEPTH_COLUMNS)
    by_taxon = split(taxon, TAXON_COLUMNS)

    # inner joins on the model name, in the order of the final average
    rows = [c for c in scored if c in split_cols]
    if performance_by_depth:
        depth_means = {}
        for d in MUTATION_DEPTHS:
            dcols = [c for c in all_columns if c.split("_")[-1] == d]
            dmean = column_mean(uf_mean[:, [scored.index(c) for c in dcols]])
            depth_means[d] = {"_".join(c.split("_")[:-1]): v for c, v in zip(dcols, dmean)}
        rows = [r for r in rows if all(r in depth_means[d] for d in MUTATION_DEPTHS)]
    average = np.asarray([final_average[scored.index(r)] for r in rows])
    order = order_descending(average)
    rows = [rows[i] for i in order]

    summary = Table(n_rows=len(rows))
    type_map = model_types or {m.name: m.model_type for m in registry}
    summary["Model_name"] = np.asarray([registry.clean_name(r) for r in rows], dtype=object)
    summary["Model type"] = np.asarray([type_map.get(r) for r in rows], dtype=object)
    summary[f"Average_{metric}"] = _round3(average[order])
    summary[f"Bootstrap_standard_error_{metric}"] = _round3([se_of.get(r, np.nan) for r in rows])
    for c in FUNCTION_COLUMNS:
        name = c[len("Function_"):]
        summary[c] = (f_table[functions.index(name), [scored.index(r) for r in rows]]
                      if name in functions else np.full(len(rows), np.nan))
    for by in (by_msa, by_taxon):
        for name, vals in by.items():
            summary[name] = _round3([vals[split_cols.index(r)] for r in rows])
    if performance_by_depth:
        for d in MUTATION_DEPTHS:
            summary[f"Depth_{d}"] = _round3([depth_means[d][r] for r in rows])
    summary["Model details"] = np.asarray([registry.model_details.get(r) for r in rows],
                                          dtype=object)
    summary["References"] = np.asarray([registry.model_references.get(r) for r in rows],
                                       dtype=object)
    ranks = list(range(1, len(rows) + 1))
    if output_dir is not None:
        t0 = time.perf_counter()
        path = output_dir / metric / f"Summary_performance_{filename}.csv"
        write_csv(path, summary, index=ranks, index_label="Model_rank")
        if write_html:
            write_table_html(path.with_suffix(".html"), summary, index=ranks,
                             index_label="Model_rank")
        clock["io"] = clock.get("io", 0.0) + time.perf_counter() - t0
    out = Table({"Model_rank": np.asarray(ranks, dtype=np.int64)}, n_rows=len(rows))
    for c in summary.names:
        out[c] = summary[c]
    return out


def _write_columns(path, header: List[str], cols: List[np.ndarray]) -> None:
    """A CSV whose header may repeat a name (the JAX package's function-
    level file lists ``Selection Type`` twice)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        for i in range(len(cols[0]) if cols else 0):
            w.writerow([format_cell(c[i]) for c in cols])


def directory_scores_loader(merged_scores_dir: str | Path) -> Callable[[str], Optional[Table]]:
    """Default loader: one ``<DMS_id>.csv`` per assay in a directory; the
    DMS score columns are parsed, model columns on first use."""
    merged_scores_dir = Path(merged_scores_dir)

    def load(dms_id: str) -> Optional[Table]:
        path = merged_scores_dir / f"{dms_id}.csv"
        if not path.exists():
            return None
        return read_csv(path, numeric=("DMS_score", "DMS_score_bin"))

    return load
