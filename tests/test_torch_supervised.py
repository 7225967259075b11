"""The supervised merge and evaluation of the port against the JAX package's
functions on one world of assays and per-scheme prediction files: the
merged files' floats within 2e-12 (pandas' CSV float parser is not
correctly rounded; the port's is), the long Spearman/MSE table likewise,
and every metric file of ``evaluate_supervised`` equal byte for byte."""

import csv
import filecmp
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from proteingym_tpu.data.reference import load_reference as jload
from proteingym_tpu.data.registry import registry_from_dict as jregistry
from proteingym_tpu.merge.supervised import merge_supervised as jmerge
from proteingym_tpu.merge.supervised import supervised_filesystem_loaders as jloaders
from proteingym_tpu.metrics.supervised import evaluate_supervised as jevaluate
from proteingym_tpu_torch.data.reference import load_reference as tload
from proteingym_tpu_torch.data.registry import registry_from_dict as tregistry
from proteingym_tpu_torch.data.table import read_csv
from proteingym_tpu_torch.merge.supervised import merge_supervised as tmerge
from proteingym_tpu_torch.merge.supervised import supervised_filesystem_loaders as tloaders
from proteingym_tpu_torch.metrics.supervised import evaluate_supervised as tevaluate

AA = "ACDEFGHIKLMNPQRSTVWY"
MERGED_ATOL = 2e-12
SCHEMES = ["fold_random_5", "fold_modulo_5", "fold_contiguous_5"]
MODELS = {
    "GoodGP": {"input_score_name": "y_pred", "location": "goodgp", "key": "mutant",
               "label_name": "y_true", "model_type": "Supervised"},
    "BadRidge": {"input_score_name": "y_pred", "location": "badridge", "key": "mutant",
                 "label_name": "y_true", "model_type": "Supervised"},
    "MidNPT": {"input_score_name": "pred", "location": "midnpt", "key": "mutant",
               "label_name": "y_true", "model_type": "Supervised"},
}


def write_world(root: Path, all_categories=True, seed=0):
    """Seven assays over five UniProts (two with two assays), every depth and
    taxon category (the reference's positional rename) or a subset; three
    models, MidNPT missing one assay's files and repeating a mutant."""
    rs = np.random.RandomState(seed)
    taxa = ["Human", "Eukaryote", "Prokaryote", "Virus"] if all_categories else ["Human",
                                                                                 "Virus"]
    depths = ["low", "Medium", "High"] if all_categories else ["Medium", "High"]
    rows = []
    (root / "dms").mkdir(parents=True)
    for k in range(7):
        dms_id, length = f"P{k}_Test_2026", 16 + k
        target = "".join(rs.choice(list(AA), length))
        muts = [f"{target[p]}{p + 1}{a}" for p in range(length) for a in "AW" if a != target[p]]
        y = rs.normal(size=len(muts))
        pd.DataFrame({"mutant": muts, "DMS_score": y, "DMS_score_bin": (y > 0).astype(int),
                      "fold_random_5": rs.randint(0, 5, len(muts))}).to_csv(
            root / "dms" / f"{dms_id}.csv", index=False)
        for cv in SCHEMES:
            for model, noise in (("GoodGP", 0.3), ("BadRidge", None), ("MidNPT", 1.0)):
                if model == "MidNPT" and k == 4:
                    continue
                pred = rs.normal(size=len(y)) if noise is None else y + rs.normal(0, noise, len(y))
                frame = pd.DataFrame({"mutant": muts, MODELS[model]["input_score_name"]: pred,
                                      "y_true": y})
                if model == "MidNPT":  # a repeated mutant: averaged
                    frame = pd.concat([frame, frame.iloc[:2].assign(pred=frame["pred"][:2] + 1)])
                d = root / "scores" / cv / MODELS[model]["location"]
                d.mkdir(parents=True, exist_ok=True)
                frame.to_csv(d / f"{dms_id}.csv", index=False)
        rows.append({"DMS_id": dms_id, "DMS_filename": f"{dms_id}.csv",
                     "UniProt_ID": f"UP{min(k, 4) if k != 6 else 1}", "target_seq": target,
                     "seq_len": length, "taxon": taxa[k % len(taxa)],
                     "coarse_selection_type": ["Activity", "Stability", "Binding",
                                               "Expression"][k % 4],
                     "MSA_Neff_L_category": depths[k % len(depths)]})
    pd.DataFrame(rows).to_csv(root / "reference.csv", index=False)


def _rows(path):
    with open(path, newline="") as f:
        return list(csv.reader(f))


def assert_same_csv(got: Path, want: Path, atol=MERGED_ATOL):
    g, w = _rows(got), _rows(want)
    assert g[0] == w[0], (got, g[0], w[0])
    assert len(g) == len(w)
    for gr, wr in zip(g[1:], w[1:]):
        for name, a, b in zip(g[0], gr, wr):
            if a == b:
                continue
            assert a and b, (got, name, a, b)  # an empty field on one side only
            assert abs(float(a) - float(b)) <= atol, (got, name, a, b)


@pytest.fixture(scope="module")
def merged(tmp_path_factory):
    root = tmp_path_factory.mktemp("supervised")
    write_world(root / "world")
    jlong = jmerge(jload(root / "world" / "reference.csv"), jregistry(MODELS),
                   *jloaders(root / "world" / "dms", root / "world" / "scores"),
                   output_dir=root / "jax")
    tlong = tmerge(tload(root / "world" / "reference.csv"), tregistry(MODELS),
                   *tloaders(root / "world" / "dms", root / "world" / "scores"),
                   output_dir=root / "port", device="cpu")
    return root, jlong, tlong


def test_merged_files_match_jax(merged):
    root, jlong, tlong = merged
    assert len(tlong) == len(jlong) == 7 * 3 * 3
    assert tlong["DMS_id"].tolist() == jlong["DMS_id"].tolist()
    assert tlong["model_name"].tolist() == jlong["model_name"].tolist()
    np.testing.assert_allclose(tlong["Spearman"], jlong["Spearman"], atol=MERGED_ATOL, rtol=0)
    assert np.isnan(tlong["Spearman"]).sum() == 3  # MidNPT's missing assay, per scheme
    for path in sorted((root / "jax").rglob("*.csv")):
        assert_same_csv(root / "port" / path.relative_to(root / "jax"), path)
    # a planted fault: the pairwise-complete rows dropped for NaN-filled ranks
    from proteingym_tpu_torch.merge import supervised as tsup
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsup, "_pair_metrics", lambda t, p, d: (float(np.corrcoef(t, p)[0, 1]),
                                                           float(np.mean((t - p) ** 2))))
        bad = tmerge(tload(root / "world" / "reference.csv"), tregistry(MODELS),
                     *tloaders(root / "world" / "dms", root / "world" / "scores"), device="cpu")
    live = ~np.isnan(jlong["Spearman"].to_numpy())
    assert np.abs(bad["Spearman"][live] - jlong["Spearman"].to_numpy()[live]).max() > 1e-3


def test_merge_refuses_a_changed_mutant_set(tmp_path):
    write_world(tmp_path / "world")
    dms = tmp_path / "world" / "dms" / "P0_Test_2026.csv"
    frame = pd.read_csv(dms)
    pd.concat([frame, frame.iloc[:1]]).to_csv(dms, index=False)  # a duplicated assay row
    with pytest.raises(ValueError, match="changed the mutant set"):
        tmerge(tload(tmp_path / "world" / "reference.csv"), tregistry(MODELS),
               *tloaders(tmp_path / "world" / "dms", tmp_path / "world" / "scores"),
               device="cpu")


@pytest.mark.parametrize("all_categories", [True, False], ids=["quirk", "subset"])
def test_evaluate_files_equal_jax(tmp_path, all_categories):
    write_world(tmp_path / "world", all_categories=all_categories, seed=1)
    ref = tmp_path / "world" / "reference.csv"
    long_path = tmp_path / "merged_scores_substitutions_DMS.csv"
    jlong = jmerge(jload(ref), jregistry(MODELS),
                   *jloaders(tmp_path / "world" / "dms", tmp_path / "world" / "scores"))
    jlong.to_csv(long_path, index=False)
    kw = dict(bootstrap_samples=200, clean_names={"GoodGP": "Good GP"},
              model_types={"Good GP": "Supervised"}, model_references={"Good GP": "<a>ref</a>"})
    jevaluate(pd.read_csv(long_path), jload(ref), tmp_path / "jax", **kw)
    summaries = tevaluate(read_csv(long_path, numeric=("Spearman", "MSE")), tload(ref),
                          tmp_path / "port", **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.csv"))
    assert len(files) == 2 * (1 + 3 + 1)
    assert files == sorted(p.relative_to(tmp_path / "port")
                           for p in (tmp_path / "port").rglob("*.csv"))
    for rel in files:
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "jax" / rel, shallow=False), rel
    assert summaries["Spearman"]["Model_name"][0] == "Good GP"
    assert summaries["MSE"]["Model_name"][0] == "Good GP"
