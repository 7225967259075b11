"""The port's merge -> evaluate -> leaderboard pipeline
(proteingym_tpu_torch.merge, .metrics) against the JAX package on one tiny
world: every CSV the JAX package writes exists in the port's output with
the same header, row order and values (NaN in the same places, bootstrap
SEs equal), and the files cross between the packages in both directions."""

import csv
import json
import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

jax = pytest.importorskip("jax")

from proteingym_tpu.data import reference as jref
from proteingym_tpu.data import registry as jreg
from proteingym_tpu.merge import merge as jmerge
from proteingym_tpu.metrics import aggregate as jagg
from proteingym_tpu.metrics import clinical as jclin
from proteingym_tpu_torch.data import reference as tref
from proteingym_tpu_torch.data import registry as treg
from proteingym_tpu_torch.data import table as ttable
from proteingym_tpu_torch.merge import merge as tmerge
from proteingym_tpu_torch.metrics import aggregate as tagg
from proteingym_tpu_torch.metrics import clinical as tclin

AA = "ACDEFGHIKLMNPQRSTVWY"
BOOT = 300

# (DMS_id, UniProt, taxon, selection type, MSA depth) — U1 has four assays
# (even groups put the 3-decimal means on rounding ties), U2 two assays of
# two selection types, no Eukaryote and no "Low" depth (absent categories),
# lower-case depth categories (the first-letter quirk), one UniProt-less
# assay, and one assay whose DMS file is missing.
ASSAYS = [
    ("U1_A", "U1", "Human", "Activity", "medium"),
    ("U1_B", "U1", "Human", "Activity", "Medium"),
    ("U1_C", "U1", "Human", "Stability", "medium"),
    ("U1_D", "U1", "Human", "Activity", "Medium"),
    ("U2_A", "U2", "Prokaryote", "Binding", "High"),
    ("U2_B", "U2", "Prokaryote", "Expression", "high"),
    ("U3_A", "U3", "Virus", "OrganismalFitness", "High"),
    ("U4_A", "U4", "Prokaryote", "Stability", "Medium"),
    ("U5_A", "U5", "Human", "Stability", "High"),
    ("NOUP_A", "", "Virus", "Activity", "Medium"),
    ("GONE_A", "U6", "Human", "Activity", "High"),
]
# model -> (input score name, directionality, signal)
MODELS = {"Good": ("good_score", 1, 1.0), "Flip": ("neg", -1, 0.5),
          "Noise": ("noise_score", 1, 0.0), "Sparse": ("sparse", 1, 0.3)}


def _mutants(seq, rng, n):
    out = []
    for i in range(n):
        depth = 1 + i % 6
        pos = sorted(rng.choice(len(seq), depth, replace=False))
        out.append(":".join(f"{seq[p]}{p + 1}{AA[(AA.index(seq[p]) + 3) % 20]}" for p in pos))
    return list(dict.fromkeys(out))


def build_world(root: Path, indels: bool = False) -> Path:
    """Reference, DMS files, per-model score files and a config.json."""
    rng = np.random.default_rng(11 if indels else 7)
    for d in ("dms", "scores"):
        (root / d).mkdir(parents=True, exist_ok=True)
    ref_rows = []
    for k, (dms_id, uni, taxon, sel, depth) in enumerate(ASSAYS):
        seq = "".join(rng.choice(list(AA), 30 + 3 * k))
        muts = _mutants(seq, rng, 40 + 7 * k)
        n = len(muts)
        y = rng.normal(size=n)
        mutated = [seq[:3] + "G" * (i % 4) + seq[3 + i % 3:] for i in range(n)] if indels else None
        dms = pd.DataFrame({"mutant": muts, "DMS_score": y,
                            "DMS_score_bin": (y > np.quantile(y, 0.7)).astype(int)})
        if indels:
            dms.insert(1, "mutated_sequence", [f"{s}{i}" for i, s in enumerate(mutated)])
        if dms_id == "U3_A":
            dms.loc[3, "DMS_score"] = np.nan  # a missing measurement
        if dms_id != "GONE_A":
            dms.to_csv(root / "dms" / f"{dms_id}.csv", index=False)
        key_col = "mutated_sequence" if indels else "mutant"
        for model, (col, direction, signal) in MODELS.items():
            if model == "Sparse" and dms_id == "U2_B":
                continue  # no score file: a missing model column
            s = direction * (signal * y + rng.normal(size=n))
            if model == "Noise":
                s = np.round(s, 1)  # ties
            frame = pd.DataFrame({key_col: dms[key_col], col: s})
            if model == "Good" and dms_id == "U1_A":
                frame = pd.concat([frame, frame.iloc[:3]])  # duplicated rows
            if model == "Flip" and dms_id == "U1_B":
                frame = frame.iloc[:-2]  # a strict subset: skipped
            if model == "Noise" and dms_id == "U4_A":
                frame[key_col] = [f"X{i}" for i in range(n)]  # no overlap: skipped
            if model == "Good" and dms_id == "U5_A":
                frame.loc[[2, 5], col] = np.nan  # unscored rows
            (root / "scores" / model.lower()).mkdir(exist_ok=True)
            frame.to_csv(root / "scores" / model.lower() / f"{dms_id}.csv", index=False)
        ref_rows.append({"DMS_id": dms_id, "DMS_filename": f"{dms_id}.csv", "UniProt_ID": uni,
                         "target_seq": seq, "seq_len": len(seq), "taxon": taxon,
                         "coarse_selection_type": sel, "MSA_Neff_L_category": depth,
                         "DMS_total_number_mutants": n + (1 if dms_id == "U3_A" else 0),
                         "includes_multiple_mutants": True})
    pd.DataFrame(ref_rows).to_csv(root / "reference.csv", index=False)
    field = "model_list_zero_shot_%s_DMS" % ("indels" if indels else "substitutions")
    config = {field: {m: {"input_score_name": col, "location": m.lower(),
                          "directionality": direction,
                          "key": "mutated_sequence" if indels else "mutant",
                          "model_type": "Synthetic" if m != "Noise" else ""}
                      for m, (col, direction, _) in MODELS.items()}}
    (root / "config.json").write_text(json.dumps(config))
    (root / "constants.json").write_text(json.dumps({
        "clean_names": {"Good": "Good model"},
        "model_details": {"Good": "signal plus noise", "Flip": "flipped"},
        "model_references": {"Good": "<a>ref</a>"}}))
    return root


def build_clinical_world(root: Path) -> Path:
    rng = np.random.default_rng(5)
    (root / "merged").mkdir(parents=True)
    rows = []
    for k in range(5):
        pid = f"NP_00000{k}.1"
        n = 30 + 5 * k
        labels = rng.integers(0, 2, n) if k != 2 else np.ones(n, dtype=int)  # one class
        frame = pd.DataFrame({"mutant": [f"A{i + 1}G" for i in range(n)],
                              "DMS_bin_score": labels,
                              "Good": labels + rng.normal(0, 0.8, n),
                              "Noise": np.round(rng.normal(size=n), 1)})
        if k == 3:
            frame.loc[[1, 4], "Good"] = np.nan
            frame = frame.drop(columns=["Noise"])  # a missing model column
        frame.to_csv(root / "merged" / f"{pid}.csv", index=False)
        rows.append({"protein_id": pid, "target_seq": "A" * n, "DMS_filename": f"{pid}.csv"})
    rows.append({"protein_id": "NP_999999.1", "target_seq": "A", "DMS_filename": "x.csv"})
    pd.DataFrame(rows).to_csv(root / "clinical.csv", index=False)
    config = {"model_list_zero_shot_substitutions_clinical": {
        "Good": {"input_score_name": "Good", "location": "good", "directionality": 1,
                 "key": "mutant"},
        "Noise": {"input_score_name": "Noise", "location": "noise", "directionality": 1,
                  "key": "mutant"}}}
    (root / "config.json").write_text(json.dumps(config))
    return root


def _cells(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


# pandas' default float parser is not correctly rounded: it reads a
# 17-digit score off by up to ~1e-12 relative (-0.07326182060384487 as
# -0.0732618206038448; on 200,000 random repr() strings 47% came back
# changed, the worst by 9.5e-13) and writes that back, while the port
# parses with float(). Unrounded data cells therefore agree to 2e-12; the
# rounded metric files agree exactly.
DATA_RTOL = 2e-12


def _same_value(a: str, b: str, rtol: float = 0.0) -> bool:
    if a == b:
        return True
    try:
        fa, fb = float(a), float(b)
    except ValueError:
        return False
    return math.isclose(fa, fb, rel_tol=rtol, abs_tol=0.0) or (math.isnan(fa) and math.isnan(fb))


def assert_same_csvs(want_dir: Path, got_dir: Path, rtol: float = 0.0) -> int:
    """Every CSV under ``want_dir`` has a twin under ``got_dir`` with the
    same header, rows and values (equal, or within ``rtol``); returns the
    number compared."""
    files = sorted(p.relative_to(want_dir) for p in want_dir.rglob("*.csv"))
    assert files
    for rel in files:
        want, got = _cells(want_dir / rel), _cells(got_dir / rel)
        assert got[0] == want[0], (rel, got[0], want[0])
        assert len(got) == len(want), rel
        for i, (rw, rg) in enumerate(zip(want[1:], got[1:]), start=1):
            assert len(rw) == len(rg), (rel, i)
            for h, a, b in zip(want[0], rw, rg):
                assert _same_value(a, b, rtol), (str(rel), i, h, a, b)
    assert sorted(p.relative_to(got_dir) for p in got_dir.rglob("*.csv")) == files
    return len(files)


def _run_merge(pkg, root, out, mutation_type):
    ref_mod, reg_mod, merge_mod = (jref, jreg, jmerge) if pkg == "jax" else (tref, treg, tmerge)
    reference = ref_mod.load_reference(root / "reference.csv")
    registry = reg_mod.load_registry(root / "config.json", mutation_type=mutation_type)
    loaders = merge_mod.filesystem_loaders(root / "dms", root / "scores")
    merge_mod.merge_all(reference, registry, *loaders, out, mutation_type=mutation_type)


def _run_evaluate(pkg, root, merged, out, mutation_type, **kw):
    ref_mod, reg_mod, agg = (jref, jreg, jagg) if pkg == "jax" else (tref, treg, tagg)
    reference = ref_mod.load_reference(root / "reference.csv")
    registry = reg_mod.load_registry(root / "config.json", mutation_type=mutation_type,
                                     constants_path=root / "constants.json")
    if pkg == "torch":
        kw = {"device": "cpu", **kw}
    return agg.evaluate_benchmark(reference, registry, agg.directory_scores_loader(merged),
                                  out, indel_mode=mutation_type == "indels",
                                  bootstrap_samples=BOOT, write_html=False, **kw)


@pytest.fixture(scope="module", params=["substitutions", "indels"])
def world(request, tmp_path_factory):
    mutation_type = request.param
    root = build_world(tmp_path_factory.mktemp(mutation_type), mutation_type == "indels")
    for pkg in ("jax", "torch"):
        _run_merge(pkg, root, root / f"{pkg}_merged", mutation_type)
    return root, mutation_type


def test_merge_matches_jax(world):
    root, _ = world
    assert assert_same_csvs(root / "jax_merged", root / "torch_merged",
                            DATA_RTOL) == len(ASSAYS) - 1
    merged = ttable.read_csv(root / "torch_merged" / "U1_B.csv", numeric=("DMS_score",))
    assert "Flip" not in merged  # the strict-subset model was skipped
    assert "Noise" not in ttable.read_csv(root / "torch_merged" / "U4_A.csv")  # no overlap


def test_merge_warns_about_the_mutant_count(world, caplog):
    root, mutation_type = world
    with caplog.at_level("WARNING"):
        _run_merge("torch", root, root / "torch_merged_again", mutation_type)
    text = caplog.text
    assert "Insufficient mutants for U3_A" in text
    assert "Could not find DMS file for GONE_A" in text
    assert "do not have the same mutants" in text and "No overlap on mutants" in text


@pytest.mark.parametrize("direction", ["same", "jax_merged_to_port", "port_merged_to_jax"])
def test_evaluate_matches_jax(world, direction):
    root, mutation_type = world
    jax_in = root / ("torch_merged" if direction == "port_merged_to_jax" else "jax_merged")
    port_in = root / ("jax_merged" if direction == "jax_merged_to_port" else "torch_merged")
    want, got = root / f"jax_bench_{direction}", root / f"torch_bench_{direction}"
    jsum = _run_evaluate("jax", root, jax_in, want, mutation_type)
    tsum = _run_evaluate("torch", root, port_in, got, mutation_type)
    n = assert_same_csvs(want, got)
    by_depth = mutation_type == "substitutions"
    assert n == 5 * 4
    for metric, summary in tsum.items():
        assert list(summary["Model_name"]) == list(jsum[metric]["Model_name"])
        se = f"Bootstrap_standard_error_{metric}"
        np.testing.assert_array_equal(summary[se], jsum[metric][se].to_numpy())
        assert ("Depth_5+" in summary) == by_depth


def test_evaluate_writes_the_jax_column_order(world):
    root, mutation_type = world
    out = root / "torch_bench_same" / "Spearman"
    if not out.exists():
        _run_evaluate("torch", root, root / "torch_merged", root / "torch_bench_same",
                      mutation_type)
    kind = mutation_type
    header = _cells(out / f"Summary_performance_DMS_{kind}_Spearman.csv")[0]
    assert header[:5] == ["Model_rank", "Model_name", "Model type", "Average_Spearman",
                          "Bootstrap_standard_error_Spearman"]
    assert header[-2:] == ["Model details", "References"]
    rows = _cells(out / f"Summary_performance_DMS_{kind}_Spearman.csv")[1:]
    assert [r[0] for r in rows] == [str(i) for i in range(1, 5)]
    taxa = header.index("Taxa_Other_Eukaryote")
    assert all(r[taxa] == "" for r in rows)  # an absent taxon is an empty column
    assert rows[0][1] == "Good model"  # the clean name


def test_evaluate_by_depth_on_the_device_equals_per_column_calls(world):
    """All columns and depth splits of an assay in one batched call give the
    per-column values of the JAX package's host loop."""
    root, mutation_type = world
    merged = ttable.read_csv(root / "jax_merged" / "U2_A.csv", numeric=("DMS_score",))
    jframe = pd.read_csv(root / "jax_merged" / "U2_A.csv")
    by_depth = mutation_type == "substitutions"
    got = tagg.compute_assay_table(merged, list(MODELS) + ["Absent"], by_depth, device="cpu")
    want = jagg.compute_assay_table(jframe, list(MODELS) + ["Absent"], by_depth)
    assert list(got) == list(want)
    for metric in want:
        assert list(got[metric]) == list(want[metric])
        for label, v in want[metric].items():
            assert got[metric][label] == pytest.approx(v, abs=1e-12, nan_ok=True), (metric, label)


def test_clinical_matches_jax(tmp_path):
    root = build_clinical_world(tmp_path)
    out = {}
    for pkg, ref_mod, reg_mod, agg, clin in (("jax", jref, jreg, jagg, jclin),
                                             ("torch", tref, treg, tagg, tclin)):
        reference = ref_mod.load_reference(root / "clinical.csv")
        registry = reg_mod.load_registry(root / "config.json", dataset="clinical")
        kw = {"device": "cpu"} if pkg == "torch" else {}
        out[pkg] = clin.evaluate_clinical(
            reference, registry, agg.directory_scores_loader(root / "merged"),
            root / f"{pkg}_bench", bootstrap_samples=BOOT, model_types={"Good": "MSA"}, **kw)
    assert assert_same_csvs(root / "jax_bench", root / "torch_bench") == 2
    assert list(out["torch"]["Model_name"]) == list(out["jax"]["Model_name"]) == ["Good", "Noise"]
    rows = _cells(root / "torch_bench" / "AUC" / "clinical_substitutions_AUC_DMS_level.csv")
    assert rows[0] == ["RefSeq ID", "Good", "Noise"] and rows[3][1] == ""  # one class


def test_reference_fields_match_jax(world):
    root, _ = world
    want = jref.load_reference(root / "reference.csv")
    got = tref.load_reference(root / "reference.csv")
    assert got.dms_ids == want.dms_ids and "U1_A" in got and "nope" not in got
    for a, b in zip(got, want):
        for field in ("DMS_id", "UniProt_ID", "seq_len", "taxon", "coarse_selection_type",
                      "MSA_Neff_L_category", "DMS_total_number_mutants",
                      "includes_multiple_mutants", "DMS_binarization_cutoff"):
            assert getattr(a, field) == getattr(b, field), field
    lookup = want.uniprot_lookup("MSA_Neff_L_category")
    assert got.uniprot_lookup("MSA_Neff_L_category") == [
        tuple(None if isinstance(v, float) else v for v in row)
        for row in lookup.itertuples(index=False)]
    clinical = build_clinical_world(root / "clin")
    assert (tref.load_reference(clinical / "clinical.csv").dms_ids
            == jref.load_reference(clinical / "clinical.csv").dms_ids)


@pytest.mark.parametrize("dataset,mutation_type", [
    ("DMS", "substitutions"), ("DMS", "indels"), ("clinical", "substitutions"),
    ("DMS_supervised", "substitutions")])
def test_packaged_registry_matches_jax(dataset, mutation_type):
    want = jreg.load_packaged_registry(dataset, mutation_type)
    got = treg.load_packaged_registry(dataset, mutation_type)
    assert got.names == want.names and len(got) > 0
    assert [dataclass_tuple(e) for e in got] == [dataclass_tuple(e) for e in want]
    assert got.clean_names == want.clean_names
    assert got.model_details == want.model_details
    assert got.model_references == want.model_references


def dataclass_tuple(entry):
    return (entry.name, entry.input_score_name, entry.location, entry.directionality,
            entry.key, entry.model_type, entry.label_name)


def test_table_round_trips_through_pandas(tmp_path):
    """What the port writes, pandas reads back to the same values (floats as
    repr, NaN and None empty, ints as ints), and the port reads pandas'
    files with numeric columns typed as pandas types them."""
    t = ttable.Table({"mutant": np.asarray(["A1G", "C2D:E3F", None, "x,y"], dtype=object),
                      "score": np.asarray([0.1 + 0.2, np.nan, -1e-05, 5.0]),
                      "bin": np.asarray([1, 0, 1, 1], dtype=np.int64)})
    ttable.write_csv(tmp_path / "t.csv", t)
    back = pd.read_csv(tmp_path / "t.csv", float_precision="round_trip")
    assert list(back.columns) == ["mutant", "score", "bin"] and back["bin"].dtype == np.int64
    np.testing.assert_array_equal(back["score"].to_numpy(), t["score"])
    assert back["mutant"].isna().tolist() == [False, False, True, False]
    assert back["mutant"][3] == "x,y"
    frame = pd.DataFrame({"a": [1, 2], "b": [0.5, np.nan], "c": ["u", "NA"]})
    frame.to_csv(tmp_path / "p.csv", index=False)
    got = ttable.read_csv(tmp_path / "p.csv", numeric=("a", "b"))
    assert got["a"].dtype == np.int64 and got["b"].dtype == np.float64
    assert np.isnan(got["b"][1]) and got.floats("a").tolist() == [1.0, 2.0]
    assert got["c"].tolist() == ["u", "NA"]  # string columns keep their text
