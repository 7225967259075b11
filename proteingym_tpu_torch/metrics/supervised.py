"""Supervised benchmark evaluation without pandas: Spearman and MSE across
CV schemes (counterpart of proteingym_tpu/metrics/supervised.py; the
reference's performance_DMS_supervised_benchmarks.py:37-166).

  long scores (DMS_id, model_name, fold_variable_name, Spearman, MSE)
    -> DMS-level tables (means over the schemes, and one per scheme)
    -> per scheme: (model, UniProt, function) means
        -> bootstrap SE centred on the top model (resampled within each
           function category; one ``default_rng(0)`` per scheme and metric,
           models then categories in sorted order, so the draws are the JAX
           package's)
        -> function means -> the final average
        -> MSA-depth / taxon tables, with the reference's positional rename
    -> the per-scheme summaries added as summary / n_schemes in scheme order,
       each scheme's average beside them
    -> round(3), ranked ``Summary_performance_DMS_<type>_<metric>.csv``
       (Spearman descending, MSE ascending)

pandas' reductions are reproduced where they decide a value: ``groupby``
sorts its keys, drops missing ones and takes Kahan-compensated means
(``group_mean``); ``pivot_table`` leaves out all-NaN groups, rows and
columns; ``pivot`` keeps them.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from proteingym_tpu_torch.data.reference import ReferenceSet
from proteingym_tpu_torch.data.table import Table, write_csv, write_html
from proteingym_tpu_torch.merge.supervised import CV_SCHEMES_INDELS, CV_SCHEMES_SUBS
from proteingym_tpu_torch.metrics.aggregate import MSA_DEPTH_COLUMNS as DEPTH_COLUMNS
from proteingym_tpu_torch.metrics.aggregate import (
    TAXON_COLUMNS, _round3, first_argmax, group_mean, order_descending,
)

METRICS = ["Spearman", "MSE"]
FUNCTION_CATEGORIES = ["Activity", "Binding", "Expression", "OrganismalFitness", "Stability"]


def _pivot_table(keys_a: List, keys_b: List, values: np.ndarray, name_a: str,
                 clean_names: Dict[str, str]) -> Table:
    """``pivot_table(index=a, columns=b, values=v, aggfunc="mean")
    .reset_index()``: groups with a NaN mean left out, then rows and
    columns without a value."""
    groups, means = group_mean(values, list(zip(keys_a, keys_b)))
    cells = {g: m for g, m in zip(groups, means[:, 0]) if not np.isnan(m)}
    rows = sorted({a for a, _ in cells})
    cols = sorted({b for _, b in cells})
    out = Table(n_rows=len(rows))
    out[clean_names.get(name_a, name_a)] = np.asarray(rows, dtype=object)
    for b in cols:
        out[clean_names.get(b, b)] = np.asarray([cells.get((a, b), np.nan) for a in rows])
    return out


def _write_rounded(path: Path, table: Table) -> None:
    out = Table(n_rows=len(table))
    for name in table.names:
        col = table[name]
        out[name] = _round3(col) if col.dtype.kind == "f" else col
    write_csv(path, out)


def _supervised_bootstrap(uf_keys, uf_values: np.ndarray, top_model: str,
                          number_assay_reshuffle: int = 10000, seed: int = 0) -> Dict[str, float]:
    """Bootstrap SE per model of the across-category mean, centred on the
    top model (ref :16-35); ``uf_keys`` the sorted (model, UniProt,
    function) groups and ``uf_values`` their metric means."""
    rng = np.random.default_rng(seed)
    top = {(u, f): v for (m, u, f), v in zip(uf_keys, uf_values) if m == top_model}
    out = {}
    for model in sorted({m for m, _, _ in uf_keys}):
        rows = [((u, f), v) for (m, u, f), v in zip(uf_keys, uf_values) if m == model]
        cats = sorted({f for (_, f), _ in rows})
        replicates = None
        for cat in cats:
            vals = np.asarray([v - top.get(k, np.nan) for k, v in rows if k[1] == cat],
                              dtype=np.float64)
            idx = rng.integers(0, len(vals), size=(number_assay_reshuffle, len(vals)))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", category=RuntimeWarning)
                means = np.nanmean(vals[idx], axis=1)
            replicates = means if replicates is None else replicates + means
        out[model] = float(np.std(replicates / len(cats), ddof=1))
    return out


def _two_level(models, uni, cat, values):
    """groupby([model, UniProt, cat]).mean().groupby([model, cat]).mean():
    {(model, cat): value}."""
    k1, m1 = group_mean(values, list(zip(models, uni, cat)))
    k2, m2 = group_mean(m1, [(m, c) for m, _, c in k1])
    return {k: v for k, v in zip(k2, m2[:, 0])}


def _by_category(cells: Dict, names: Dict[str, str], quirk: List[str]):
    """The ``pivot`` of {(model, category): value} with the reference's
    positional rename: when the sorted categories are ``quirk``, the
    columns take ``names``' values in their order, whatever they hold;
    otherwise each category its own name (absent ones NaN)."""
    cats = sorted({c for _, c in cells})
    if cats == quirk:
        return {new: {m: v for (m, c), v in cells.items() if c == old}
                for old, new in zip(cats, names.values())}
    return {new: {m: v for (m, c), v in cells.items() if c == old} for old, new in names.items()}


def evaluate_supervised(
    long_scores: Table,
    reference: ReferenceSet,
    output_dir: str | Path,
    mutation_type: str = "substitutions",
    top_model: Optional[str] = None,
    bootstrap_samples: int = 10000,
    clean_names: Optional[Dict[str, str]] = None,
    model_types: Optional[Dict[str, str]] = None,
    model_references: Optional[Dict[str, str]] = None,
    model_details: Optional[Dict[str, str]] = None,
    cv_schemes: Optional[Sequence[str]] = None,
    write_html_files: bool = False,
) -> Dict[str, Table]:
    """The supervised aggregation from the long table; returns {metric:
    summary} (``Model_rank`` first) and writes the metric directories."""
    output_dir = Path(output_dir)
    if cv_schemes is None:
        cv_schemes = CV_SCHEMES_INDELS if mutation_type == "indels" else CV_SCHEMES_SUBS
    clean_names = clean_names or {}
    by_id = {r.DMS_id: r for r in reference}
    dms = long_scores["DMS_id"].tolist()
    models = long_scores["model_name"].tolist()
    schemes = long_scores["fold_variable_name"].tolist()
    meta = lambda field: [(getattr(by_id[d], field) or None) if d in by_id else None  # noqa: E731
                          for d in dms]
    uni, sel = meta("UniProt_ID"), meta("coarse_selection_type")
    neff, taxon = meta("MSA_Neff_L_category"), meta("taxon")
    vals = {m: long_scores.floats(m) for m in METRICS}
    if top_model is None:
        keys, means = group_mean(vals["Spearman"], [(m,) for m in models])
        top_model = keys[first_argmax(means[:, 0])][0]

    summaries: Dict[str, Table] = {}
    for metric in METRICS:
        metric_dir = output_dir / metric
        metric_dir.mkdir(parents=True, exist_ok=True)
        v = vals[metric]
        _write_rounded(metric_dir / f"DMS_{mutation_type}_{metric}_DMS_level.csv",
                       _pivot_table(dms, models, v, "DMS_id", clean_names))
        for cv_scheme in cv_schemes:
            sub = [i for i, s in enumerate(schemes) if s == cv_scheme]
            _write_rounded(
                metric_dir / f"DMS_{mutation_type}_{metric}_DMS_level_{cv_scheme}.csv",
                _pivot_table([dms[i] for i in sub], [models[i] for i in sub], v[sub], "DMS_id",
                             clean_names))

        all_summary: Optional[Dict[str, Dict[str, float]]] = None
        for cv_scheme in cv_schemes:
            sub = [i for i, s in enumerate(schemes) if s == cv_scheme]
            if not sub:
                raise ValueError(f"No scores for CV scheme {cv_scheme}")
            m_, u_, f_ = ([x[i] for i in sub] for x in (models, uni, sel))
            uf_keys, uf_mean = group_mean(v[sub], list(zip(m_, u_, f_)))
            se = _supervised_bootstrap(uf_keys, uf_mean[:, 0], top_model,
                                       number_assay_reshuffle=bootstrap_samples)
            fa_keys, fa_mean = group_mean(uf_mean, [(m, f) for m, _, f in uf_keys])
            fin_keys, fin_mean = group_mean(fa_mean, [(m,) for m, _ in fa_keys])
            summary: Dict[str, Dict[str, float]] = {
                f"Average_{metric}": {k[0]: x for k, x in zip(fin_keys, fin_mean[:, 0])}}
            summary.update(_by_category(
                _two_level(m_, u_, [neff[i] for i in sub], v[sub]), DEPTH_COLUMNS,
                ["High", "Low", "Medium"]))
            summary.update(_by_category(
                _two_level(m_, u_, [taxon[i] for i in sub], v[sub]), TAXON_COLUMNS,
                ["Eukaryote", "Human", "Prokaryote", "Virus"]))
            for cat in sorted({f for _, f in fa_keys}):
                summary[f"Function_{cat}"] = {m: x for (m, f), x in zip(fa_keys, fa_mean[:, 0])
                                              if f == cat}
            summary[f"Bootstrap_standard_error_{metric}"] = se
            if all_summary is None:  # its models are the index from here on
                names = sorted({m for col in summary.values() for m in col})
                all_summary = {c: {m: col.get(m, np.nan) / len(cv_schemes) for m in names}
                               for c, col in summary.items()}
            else:
                for c, col in all_summary.items():
                    if not c.startswith(f"Average_{metric}_"):
                        for m in names:
                            col[m] = col[m] + summary[c].get(m, np.nan) / len(cv_schemes)
            average = summary[f"Average_{metric}"]
            all_summary[f"Average_{metric}_{cv_scheme}"] = {m: average.get(m, np.nan)
                                                            for m in names}

        column = lambda c: np.asarray([all_summary[c].get(m, np.nan) for m in names])  # noqa: E731
        average = column(f"Average_{metric}")
        if metric == "MSE":
            live = np.flatnonzero(~np.isnan(average))
            order = np.concatenate([live[np.argsort(average[live], kind="stable")],
                                    np.flatnonzero(np.isnan(average))])
        else:
            order = order_descending(average)
        ranked = [names[i] for i in order]
        clean = [clean_names.get(m, m) for m in ranked]
        table = Table(n_rows=len(ranked))
        table["Model_name"] = np.asarray(clean, dtype=object)
        table["Model type"] = np.asarray([(model_types or {}).get(m, "") for m in clean],
                                         dtype=object)
        cols = ([f"Average_{metric}", f"Bootstrap_standard_error_{metric}"]
                + [f"Average_{metric}_{s}" for s in cv_schemes]
                + [f"Function_{c}" for c in FUNCTION_CATEGORIES]
                + list(DEPTH_COLUMNS.values()) + list(TAXON_COLUMNS.values()))
        for c in cols:
            if c in all_summary:
                table[c] = _round3(column(c)[order])
            else:  # a function category no assay has
                table[c] = np.asarray(["N/A"] * len(ranked), dtype=object)
        table["References"] = np.asarray([(model_references or {}).get(m, "") for m in clean],
                                         dtype=object)
        table["Model details"] = np.asarray([(model_details or {}).get(m, "") for m in clean],
                                            dtype=object)
        ranks = list(range(1, len(ranked) + 1))
        out_path = metric_dir / f"Summary_performance_DMS_{mutation_type}_{metric}.csv"
        write_csv(out_path, table, index=ranks, index_label="Model_rank")
        if write_html_files:
            write_html(out_path.with_suffix(".html"), table, index=ranks,
                       index_label="Model_rank")
        out = Table({"Model_rank": np.asarray(ranks, dtype=np.int64)}, n_rows=len(ranked))
        for c in table.names:
            out[c] = table[c]
        summaries[metric] = out
    return summaries
