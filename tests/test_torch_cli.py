"""The slice as a whole: the JAX CLI and the port's CLI score the same
assays with the same fair-esm checkpoint, and their score columns agree."""

import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.data.table import write_csv
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.pipeline import checkpoints as tckpt
from proteingym_tpu_torch.pipeline import cli as tcli
from tests.test_torch_esm2 import fair_esm_state
from tests.test_torch_eve_train import one_thread  # noqa: F401

ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
SUPERVISED_SCHEMES = ["fold_random_5", "fold_modulo_5", "fold_contiguous_5"]


def _write_assays(root, n_assays=2):
    rng = np.random.default_rng(0)
    dms_dir = root / "dms"
    dms_dir.mkdir()
    ref_rows = []
    for i in range(n_assays):
        seq = "".join(rng.choice(list(AA), 18 + 7 * i))
        dms_id = f"SYN{i}_TEST"
        muts = [f"{seq[p]}{p + 1}{m}" for p in range(0, len(seq), 2) for m in "AGW"
                if m != seq[p]] + [f"{seq[0]}1K:{seq[5]}6P"]
        with open(dms_dir / f"{dms_id}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["mutant", "DMS_score"])
            w.writerows([m, f"{rng.standard_normal():.4f}"] for m in muts)
        ref_rows.append([dms_id, f"{dms_id}.csv", "P0", seq, len(seq)])
    ref = root / "reference.csv"
    with open(ref, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len"])
        w.writerows(ref_rows)
    return ref, dms_dir, [r[0] for r in ref_rows]


def _save_checkpoint(path, seed):
    sd = fair_esm_state(tesm.PRESETS["esm2_tiny"], seed)
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return path


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def assays(tmp_path_factory):
    root = tmp_path_factory.mktemp("assays")
    ref, dms_dir, ids = _write_assays(root)
    a = _save_checkpoint(root / "a.pt", 31)
    b = _save_checkpoint(root / "b.pt", 32)
    return root, ref, dms_dir, ids, a, b


def _score_both(root, ref, dms_dir, extra_args, tag):
    common = ["--dms-reference", str(ref), "--dms-dir", str(dms_dir),
              "--batch-size", "8", "--quiet"] + extra_args
    rc_j = jcli.main(["--platform", "cpu", "score", "--model", "esm",
                      "--output-dir", str(root / f"jax_{tag}")] + common)
    rc_t = tcli.main(["score", "--model", "esm", "--device", "cpu",
                      "--output-dir", str(root / f"torch_{tag}")] + common)
    assert rc_j == 0 and rc_t == 0
    return root / f"jax_{tag}", root / f"torch_{tag}"


@pytest.mark.parametrize("mode", ["single", "ensemble"])
def test_port_cli_matches_jax_cli(assays, mode):
    root, ref, dms_dir, ids, a, b = assays
    if mode == "single":
        args, column = ["--checkpoint", f"esm2_tiny:{a}"], "esm2_tiny_score"
    else:
        args = ["--extra", f"ensemble=esm2_tiny:{a},esm2_tiny:{b}"]
        column = "esm2_tiny_ensemble"
    jdir, tdir = _score_both(root, ref, dms_dir, args, mode)
    for dms_id in ids:
        want, got = _read(jdir / f"{dms_id}.csv"), _read(tdir / f"{dms_id}.csv")
        assert list(got[0]) == ["mutant", "DMS_score", "mutated_sequence", column]
        assert [r["mutant"] for r in got] == [r["mutant"] for r in want]
        assert [r["mutated_sequence"] for r in got] == [r["mutated_sequence"] for r in want]
        np.testing.assert_allclose([float(r[column]) for r in got],
                                   [float(r[column]) for r in want], atol=ATOL, rtol=0)
    manifest = [json.loads(line) for line in (tdir / "manifest.jsonl").read_text().splitlines()]
    assert sorted(m["task"] for m in manifest) == sorted(f"esm/{i}" for i in ids)
    assert all(m["status"] == "done" for m in manifest)
    events = [json.loads(line)["event"] for line in (tdir / "events.jsonl").read_text().splitlines()]
    assert "throughput_summary" in events


def test_nan_score_cells_are_written_as_the_jax_cli_writes_them(tmp_path):
    # the JAX CLI writes each scores frame with pandas to_csv, whose NaN is
    # an empty field; the port's writer gives the same fields
    import pandas as pd

    columns = ["mutant", "DMS_score", "mutated_sequence"]
    rows = [{"mutant": "A1C", "DMS_score": "0.5", "mutated_sequence": "CKT"},
            {"mutant": "K2P", "DMS_score": "-1.25", "mutated_sequence": "APT"},
            {"mutant": "T3W", "DMS_score": "2.0", "mutated_sequence": "AKW"},
            {"mutant": "A1C:K2P", "DMS_score": "0.125", "mutated_sequence": "CPT"}]
    scores = {"model_score": np.array([-0.1, np.nan, 1e-07, 123456789.0]),
              "other_score": np.array([np.nan, -1.2345678901234567, 3.0, np.nan])}
    write_csv(tmp_path / "port.csv", tcli._score_table(columns, rows, scores))
    frame = pd.DataFrame({c: [r[c] for r in rows] for c in columns})
    for name, values in scores.items():
        frame[name] = values
    frame.to_csv(tmp_path / "jax.csv", index=False)
    with open(tmp_path / "port.csv", newline="") as f:
        got = list(csv.reader(f))
    with open(tmp_path / "jax.csv", newline="") as f:
        want = list(csv.reader(f))
    assert got == want
    assert got[2][3] == "" and got[1][4] == ""


def test_resume_skips_done_and_isolates_failures(tmp_path):
    ref, dms_dir, ids = _write_assays(tmp_path, n_assays=2)
    bad = dms_dir / f"{ids[1]}.csv"
    bad.write_text("mutant,DMS_score\nW1A,0.5\n")  # wild-type mismatch
    args = ["score", "--model", "esm", "--checkpoint", "esm2_tiny", "--device", "cpu",
            "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
            "--output-dir", str(tmp_path / "out"), "--quiet"]
    assert tcli.main(args) == 1  # one assay failed, the other was written
    assert (tmp_path / "out" / f"{ids[0]}.csv").exists()
    assert not (tmp_path / "out" / f"{ids[1]}.csv").exists()
    assert tcli.main(args + ["--dms-id", ids[0]]) == 0
    events = [json.loads(line) for line in (tmp_path / "out" / "events.jsonl").read_text().splitlines()]
    assert events[-1]["event"] == "task_skipped"
    with pytest.raises(ValueError, match="Invalid from_AA"):
        tcli.main(args + ["--dms-index", "1", "--fail-fast"])


def test_cuda_device_without_gpu_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, dms_dir, _ = _write_assays(tmp_path, n_assays=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["score", "--model", "esm", "--checkpoint", "esm2_tiny",
                   "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
                   "--output-dir", str(tmp_path / "out")])


def test_checkpoint_specs(tmp_path):
    pt = _save_checkpoint(tmp_path / "esm2_tiny_seed1.pt", 5)
    m1, c1 = tckpt.load_esm_checkpoint(f"esm2_tiny:{pt}", device="cpu")
    m2, c2 = tckpt.load_esm_checkpoint(f":{pt}", device="cpu")  # preset from the file name
    m3, _ = tckpt.load_esm_checkpoint(str(pt), device="cpu")
    assert c1 == c2 == tesm.PRESETS["esm2_tiny"]
    for name, p in m1.state_dict().items():
        assert torch.equal(p, m2.state_dict()[name]) and torch.equal(p, m3.state_dict()[name])
    r1, _ = tckpt.load_esm_checkpoint("esm2_tiny", device="cpu")
    r2, _ = tckpt.load_esm_checkpoint("esm2_tiny", device="cpu")
    assert torch.equal(r1.layers[0].fc1.weight, r2.layers[0].fc1.weight)  # seeded
    orbax = tmp_path / "converted"
    orbax.mkdir()
    with pytest.raises(ValueError, match="JAX-only"):
        tckpt.load_esm_checkpoint(str(orbax), device="cpu")
    with pytest.raises(ValueError, match="needs --checkpoint"):
        tckpt.load_esm_checkpoint(None, device="cpu")


# ---------------------------------------------------------------------------
# The alignment trainers: train --model eve|potts, and the eve /
# deepsequence scorers without a checkpoint
# ---------------------------------------------------------------------------

def _train_args(tmp_path, model, steps, out):
    return ["train", "--model", model, "--dms-reference", str(tmp_path / "ref.csv"),
            "--dms-id", "FAM_T", "--msa-dir", str(tmp_path / "msa"), "--weights-dir",
            str(tmp_path / "w"), "--output-dir", str(tmp_path / out), "--steps", str(steps),
            "--seed", "3"]


@pytest.mark.usefixtures("one_thread")
def test_train_eve_writes_a_file_the_jax_package_reads(tmp_path):
    import jax.numpy as jnp

    from proteingym_tpu.models import eve as jeve
    from proteingym_tpu_torch.models import eve as teve
    from tests.test_torch_eve import ATOL, _eve_world, _onehots

    _eve_world(tmp_path)
    assert tcli.main(_train_args(tmp_path, "eve", 5, "models") + ["--device", "cpu"]) == 0
    path = tmp_path / "models" / "eve_FAM_T_seed3"
    assert path.is_file()  # a reference EVE file (the JAX CLI writes an orbax directory)
    model, config = tckpt.load_eve_checkpoint(path, device="cpu")
    assert config == teve.EveConfig(seq_len=9)  # the default architecture
    start = teve.init_random(config, seed=3, device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                     start.state_dict().values()))
    params, jcfg = jeve.load_torch_checkpoint(path)
    x = _onehots(np.random.RandomState(3), 4, 9)
    with torch.no_grad():
        mu, logvar = model.encode(torch.from_numpy(x))
    jmu, jlogvar = jeve.encode(params, jcfg, jnp.asarray(x))
    np.testing.assert_allclose(mu.numpy(), jmu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(logvar.numpy(), jlogvar, atol=ATOL, rtol=0)
    # the decoder with the JAX decode's own draws, one key each in its order
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, 4 + 2 * len(jcfg.decoder_hidden))
    noise = [torch.from_numpy(np.array(jax.random.normal(k, mean.shape), np.float32))[None]
             for k, (mean, _) in zip(keys, model.variational())]
    z = np.random.RandomState(4).randn(4, jcfg.z_dim).astype(np.float32)
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z)[None], noise=noise)[0].numpy()
    np.testing.assert_allclose(got, jeve.decode(params, jcfg, jnp.asarray(z), key),
                               atol=ATOL, rtol=0)


@pytest.mark.usefixtures("one_thread")
def test_train_potts_writes_the_jax_cli_file(tmp_path):
    from proteingym_tpu.models import potts as jpotts
    from proteingym_tpu_torch.models import potts as tpotts
    from tests.test_torch_eve import _eve_world
    from tests.test_torch_potts import PLM_ATOL

    _eve_world(tmp_path)
    assert tcli.main(_train_args(tmp_path, "potts", 20, "port") + ["--device", "cpu"]) == 0
    assert jcli.main(["--platform", "cpu"] + _train_args(tmp_path, "potts", 20, "jax")) == 0
    got = tpotts.read_plmc_model(tmp_path / "port" / "potts_FAM_T_seed3.model")
    want = jpotts.read_plmc_model(str(tmp_path / "jax" / "potts_FAM_T_seed3.model"))
    np.testing.assert_array_equal(got.index_list, want.index_list)
    assert got.target_seq == want.target_seq
    np.testing.assert_allclose(got.h, want.h, atol=PLM_ATOL, rtol=0)
    np.testing.assert_allclose(got.J, want.J, atol=PLM_ATOL, rtol=0)
    assert np.abs(got.J).max() > 1e-3  # the couplings moved


SMALL_VAE = ["encoder_hidden=24,16", "decoder_hidden=16,24", "z_dim=4"]


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("model,extra,column", [
    ("eve", SMALL_VAE, "evol_indices"),
    ("eve", SMALL_VAE + ["seeds=1,2"], "evol_indices_ensemble"),
    ("deepsequence", SMALL_VAE, "DeepSequence_evol_indices"),
], ids=["eve", "eve_ensemble", "deepsequence"])
def test_eve_scorers_train_without_a_checkpoint(tmp_path, model, extra, column):
    from tests.test_torch_eve import _eve_world

    _eve_world(tmp_path)
    common = ["--model", model, "--msa-dir", str(tmp_path / "msa"), "--weights-dir",
              str(tmp_path / "w"), "--dms-reference", str(tmp_path / "ref.csv"), "--dms-dir",
              str(tmp_path / "dms"), "--quiet", "--extra", "train_steps=20", "num_samples=6",
              *extra]
    assert tcli.main(["score", "--device", "cpu", "--output-dir", str(tmp_path / "port")]
                     + common) == 0
    assert jcli.main(["--platform", "cpu", "score", "--output-dir", str(tmp_path / "jax")]
                     + common) == 0
    with open(tmp_path / "port" / "FAM_T.csv", newline="") as f:
        port = list(csv.reader(f))
    with open(tmp_path / "jax" / "FAM_T.csv", newline="") as f:
        want = list(csv.reader(f))
    assert port[0] == want[0] == ["mutant", "mutated_sequence", column]
    assert [r[:2] for r in port] == [r[:2] for r in want]
    # off the focus, a wrong letter, a letter outside the alphabet: empty
    # on both sides; the rest finite, the literal WT row 0 in the port
    assert [r[2] == "" for r in port[1:]] == [r[2] == "" for r in want[1:]] == \
        [False, False, False, True, True, True, False]
    got = np.asarray([float(r[2]) for r in port[1:] if r[2]])
    assert np.isfinite(got).all() and got[-1] == 0.0 and len(set(got[:3])) == 3


@pytest.mark.parametrize("model,architecture", [
    ("eve", ((2000, 1000, 300), (300, 1000, 2000), 50)),
    ("deepsequence", ((1500, 1500), (100, 500), 30)),
])
def test_eve_scorers_train_their_architectures(tmp_path, monkeypatch, model, architecture):
    # without --extra the scorers train the JAX scorer's architectures for
    # 10,000 steps from seed 42; the training itself is replaced here by
    # the untrained model (the tests above train)
    from proteingym_tpu_torch.models import eve as teve
    from tests.test_torch_eve import _eve_world

    _eve_world(tmp_path)
    calls = []

    def untrained(onehot, weights, config, steps, seed, device):
        calls.append((config, steps, seed, onehot.shape, len(weights)))
        return teve.init_random(config, seed=seed, device=device)

    monkeypatch.setattr(teve, "train", untrained)
    assert tcli.main(["score", "--model", model, "--device", "cpu", "--msa-dir",
                      str(tmp_path / "msa"), "--dms-reference", str(tmp_path / "ref.csv"),
                      "--dms-dir", str(tmp_path / "dms"), "--output-dir", str(tmp_path / "out"),
                      "--quiet", "--fail-fast", "--extra", "num_samples=2"]) == 0
    (config, steps, seed, shape, n_weights), = calls
    assert (config.encoder_hidden, config.decoder_hidden, config.z_dim) == architecture
    assert (config.seq_len, steps, seed, shape, n_weights) == (9, 10_000, 42, (31, 9, 20), 31)


def test_models_lists_the_registry(capsys):
    from proteingym_tpu_torch.pipeline.scorers import SCORERS

    assert tcli.main(["models"]) == 0
    names = capsys.readouterr().out.split("\n")
    assert names[-1] == "" and names[:-1] == sorted(SCORERS)
    assert {"gemme", "escott", "siterm", "rsalor", "provean"} <= set(names)
    assert {"progen2", "rita", "protgpt2", "progen3", "unirep"} <= set(names)
    assert {"esmc", "esm3", "xtrimopglm", "carp"} <= set(names)
    assert {"esm_if1", "protein_mpnn", "saprot"} <= set(names)
    assert {"prosst", "venusrem", "mulan", "mif", "mif_st"} <= set(names)
    assert {"protssn", "s2f", "s3f", "s3f_msa", "aido"} <= set(names)
    assert {"vespa", "vespag", "ohe_ridge", "embeddings_ridge", "proteinnpt", "kermut"} <= set(names)
    assert len(SCORERS) == 45


# the AR zoo on the CPU: the tiny float32 shapes (head dims 8 and 16), a
# 1 x 16 ProtGPT2 with the byte-level tokens, UniRep at hidden 32 evotuned
# for 3 steps on the assay's alignment (its weights computed and cached)
ZOO_RUNS = {
    "progen2": (["tiny=1"], "progen2-small_score"),
    "rita": (["tiny=1"], "RITA_s_score"),
    "protgpt2": (["num_layers=1", "embed_dim=16", "num_heads=2"], "ProtGPT2_score"),
    "progen3": (["tiny=1"], "progen3-112m_score"),
    "unirep": (["hidden_dim=32", "embed_dim=8", "evotune_steps=3"], "unirep_score"),
}


@pytest.mark.parametrize("model", sorted(ZOO_RUNS))
def test_ar_zoo_scorers_through_the_cli(tmp_path, model):
    from tests.test_torch_gemme import write_baseline_world

    _, mutants = write_baseline_world(tmp_path, n_rows=60, indel=True)
    extra, column = ZOO_RUNS[model]
    out = tmp_path / "out"
    assert tcli.main(["score", "--model", model, "--device", "cpu", "--msa-dir",
                      str(tmp_path / "msa"), "--weights-dir", str(tmp_path / "w"),
                      "--dms-reference", str(tmp_path / "ref.csv"), "--dms-dir",
                      str(tmp_path / "dms"), "--output-dir", str(out), "--batch-size", "8",
                      "--quiet", "--fail-fast", "--extra", *extra]) == 0
    rows = _read(out / "FAM_B.csv")
    # the JAX scorers' frames: the assay's columns, then (AR harness) both
    # directions' scores and their mean under the model's column
    both = [] if model == "unirep" else ["avg_score_L_to_R", "avg_score_R_to_L"]
    assert list(rows[0]) == ["mutant", "mutated_sequence", "DMS_score", "DMS_score_bin",
                             *both, column]
    assert [r["mutated_sequence"] for r in rows] == mutants
    values = np.asarray([float(r[column]) for r in rows])
    assert np.isfinite(values).all() and (values < 0).all()
    assert (tmp_path / "w" / "FAM.npy").exists() == (model == "unirep")


@pytest.mark.parametrize("model", ["gemme", "escott", "siterm", "rsalor", "provean",
                                   "progen2", "rita", "protgpt2", "progen3", "unirep",
                                   "esmc", "esm3", "xtrimopglm", "carp", "esm_if1",
                                   "protein_mpnn", "saprot", "protssn", "s2f", "s3f",
                                   "s3f_msa", "aido"])
def test_alignment_baselines_on_cuda_without_gpu_raise(tmp_path, monkeypatch, model):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref, dms_dir, _ = _write_assays(tmp_path, n_assays=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["score", "--model", model, "--dms-reference", str(ref), "--dms-dir",
                   str(dms_dir), "--msa-dir", str(tmp_path), "--output-dir",
                   str(tmp_path / "out")])


def test_structure_dir_finds_the_jax_scorers_file(tmp_path):
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu.pipeline.scorers import ScoreContext as JContext
    from proteingym_tpu_torch.data.reference import load_reference
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    ref, _, ids = _write_assays(tmp_path, n_assays=1)
    rec = load_reference(ref)[ids[0]]
    ctx = tscorers.ScoreContext(record=rec, mutants=[], device=torch.device("cpu"))
    jctx = JContext(record=rec, dms_frame=None)
    with pytest.raises(FileNotFoundError, match="needs --structure-dir"):
        tscorers._load_structure(ctx)
    with pytest.raises(FileNotFoundError, match="needs --structure-dir"):
        jextra._load_structure(jctx)
    pdbs = tmp_path / "pdb"
    pdbs.mkdir()
    ctx.structure_dir = jctx.structure_dir = pdbs
    with pytest.raises(FileNotFoundError, match="No PDB"):
        tscorers._load_structure(ctx)
    write_pdb_backbone(pdbs / f"{rec.DMS_id}.pdb", synthetic_helix_backbone(7), "ACDEFGH")
    assert ctx.structure_path() == pdbs / f"{rec.DMS_id}.pdb"
    write_pdb_backbone(pdbs / f"{rec.UniProt_ID}.pdb", synthetic_helix_backbone(9), "ACDEFGHIK")
    assert ctx.structure_path() == pdbs / f"{rec.UniProt_ID}.pdb"  # the UniProt file first
    np.testing.assert_array_equal(tscorers._load_structure(ctx), jextra._load_structure(jctx))
    assert tscorers._load_structure(ctx).shape == (9, 4, 3)


# the masked LMs on the CPU at their tiny presets (bf16 ESM-C and
# xTrimoPGLM, float32 ESM3, CARP-600k), each on one assay with a literal WT
# row and a synonymous one: (extra arguments, column, what the WT row gives)
MLM_RUNS = {
    "esmc": (["--checkpoint", "esmc_tiny"], "esmc_tiny_score", 0.0),
    "esmc_wt": (["--checkpoint", "esmc_tiny", "--extra", "scoring_strategy=wt-marginals"],
                "esmc_tiny_score", 0.0),
    "esm3": ([], "ESM3_score", 0.0),
    "esm3_structure": (["--structure-dir", "pdb"], "ESM3_score", 0.0),
    "xtrimopglm": (["--checkpoint", "xtrimopglm_tiny"], "xtrimopglm_score", None),
    "xtrimopglm_ar": (["--checkpoint", "xtrimopglm_tiny", "--extra", "mode=ar"],
                      "xtrimopglm_score", None),
    "carp": ([], "carp_600k_score", "fails"),
}


@pytest.mark.parametrize("run", sorted(MLM_RUNS))
def test_masked_lm_scorers_through_the_cli(tmp_path, run):
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone

    ref, dms_dir, (dms_id,) = _write_assays(tmp_path, n_assays=1)
    rows = _read(dms_dir / f"{dms_id}.csv")
    seq = next(r for r in csv.DictReader(open(ref)))["target_seq"]
    with open(dms_dir / f"{dms_id}.csv", "a", newline="") as f:
        csv.writer(f).writerows([["WT", "0.5"], [f"{seq[2]}3{seq[2]}", "0.1"]])
    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", synthetic_helix_backbone(len(seq)), seq)
    extra, column, wt = MLM_RUNS[run]
    extra = [str(tmp_path / a) if a == "pdb" else a for a in extra]
    out = tmp_path / "out"
    rc = tcli.main(["score", "--model", run.split("_")[0], "--device", "cpu", "--dms-reference",
                    str(ref), "--dms-dir", str(dms_dir), "--output-dir", str(out),
                    "--batch-size", "8", "--quiet", *extra])
    if wt == "fails":  # a literal WT row fails CARP's scorer, as it does the JAX one
        assert rc == 1 and not (out / f"{dms_id}.csv").exists()
        (entry,) = [json.loads(x) for x in (out / "manifest.jsonl").read_text().splitlines()]
        assert entry["status"] == "failed" and "ValueError" in entry["error"]
        lines = (dms_dir / f"{dms_id}.csv").read_text().splitlines(keepends=True)
        (dms_dir / f"{dms_id}.csv").write_text("".join(x for x in lines if not x.startswith("WT,")))
        rc = tcli.main(["score", "--model", "carp", "--device", "cpu", "--dms-reference",
                        str(ref), "--dms-dir", str(dms_dir), "--output-dir", str(out),
                        "--batch-size", "8", "--quiet"])
    assert rc == 0
    got = _read(out / f"{dms_id}.csv")
    assert list(got[0]) == ["mutant", "DMS_score", "mutated_sequence", column]
    values = {r["mutant"]: (float(r[column]) if r[column] else np.nan) for r in got}
    assert len(got) == len(rows) + (1 if wt == "fails" else 2)
    assert values[f"{seq[2]}3{seq[2]}"] == 0.0
    if wt is None:
        assert np.isnan(values["WT"])  # dropped by the recipe, as in the JAX scorer
    elif wt != "fails":
        assert values["WT"] == wt
    muts = [r["mutant"] for r in rows]
    assert np.isfinite([values[m] for m in muts]).all()
    assert len({values[m] for m in muts}) > len(muts) // 2


# the backbone-conditioned scorers, each on one weight set through both CLIs
# (--device cpu): the port reads a state dict file in the published layout
# through --checkpoint; the JAX CLI reads ProteinMPNN's the same way, and
# gets ESM-IF1's and SaProt's through its patched init (it reads only
# presets and orbax directories for them). (port arguments, JAX arguments,
# column)
STRUCTURE_RUNS = {
    "esm_if1": ([], [], "esm_if1_score"),
    "esm_if1_complex": (["--extra", "complex_chains=A,B", "target_chain=A"],
                        ["--extra", "complex_chains=A,B", "target_chain=A"], "esm_if1_score"),
    "protein_mpnn": (["--extra", "num_seq_per_target=3"], ["--extra", "num_seq_per_target=3"],
                     "pmpnn_ll"),
    "saprot": ([], [], "SaProt_score"),
}


@pytest.mark.parametrize("run", sorted(STRUCTURE_RUNS))
def test_structure_scorers_match_the_jax_cli(tmp_path, monkeypatch, run):
    import dataclasses

    from proteingym_tpu.models import esm2 as jesm
    from proteingym_tpu.models import gvp_transformer as jg
    from proteingym_tpu.models import saprot as js
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
    from proteingym_tpu_torch.models import gvp_transformer as tg
    from proteingym_tpu_torch.models import saprot as ts
    from tests import test_torch_esm_if1, test_torch_protein_mpnn, test_torch_saprot

    ref, dms_dir, (dms_id,) = _write_assays(tmp_path, n_assays=1)
    seq = next(r for r in csv.DictReader(open(ref)))["target_seq"]
    backbone = synthetic_helix_backbone(len(seq), seed=2)
    backbone[:, 1] += 0.05 * np.random.RandomState(2).randn(len(seq), 3)
    (tmp_path / "pdb").mkdir()
    pdb = tmp_path / "pdb" / "P0.pdb"
    if run == "esm_if1_complex":
        test_torch_esm_if1.write_complex_pdb(pdb, {
            "A": (backbone, seq), "B": (synthetic_helix_backbone(12, seed=3) + 11.0, "G" * 12)})
    else:
        write_pdb_backbone(pdb, backbone, seq)
    port_args, jax_args, column = STRUCTURE_RUNS[run]
    model = "esm_if1" if run.startswith("esm_if1") else run
    ckpt = tmp_path / "weights.pt"
    if model == "esm_if1":
        sd = test_torch_esm_if1.fair_esm_state(tg.PRESETS["esm_if1_tiny"], seed=5)
        with jax.enable_x64(False):
            params = jg.convert_torch_state_dict(sd, jg.PRESETS["esm_if1_tiny"])
        monkeypatch.setattr(jg, "init_params", lambda rng, c: params)
        jax_args = ["--checkpoint", "esm_if1_tiny", *jax_args]
        blob = {"model": sd, "args": None}
    elif model == "protein_mpnn":
        blob = {"model_state_dict": test_torch_protein_mpnn.reference_state(seed=5)}
        jax_args = ["--checkpoint", str(ckpt), *jax_args]
    else:
        tiny = dataclasses.replace(test_torch_saprot.TTINY, name="saprot_tiny")
        monkeypatch.setitem(ts.PRESETS, "saprot_tiny", tiny)
        sd = fair_esm_state(tiny, seed=5)
        with jax.enable_x64(False):
            params = jesm.convert_torch_state_dict(sd, test_torch_saprot.JTINY)
        monkeypatch.setattr(js, "saprot_config", lambda preset="": test_torch_saprot.JTINY)
        monkeypatch.setattr(jesm, "init_params", lambda rng, c: params)
        blob = {"model": sd}
    torch.save({k: ({n: torch.from_numpy(v) for n, v in x.items()} if isinstance(x, dict) else x)
                for k, x in blob.items()}, ckpt)
    common = ["--model", model, "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
              "--structure-dir", str(tmp_path / "pdb"), "--batch-size", "8", "--quiet"]
    with jax.enable_x64(False):
        assert jcli.main(["--platform", "cpu", "score", *common, "--output-dir",
                          str(tmp_path / "jax"), *jax_args]) == 0
    assert tcli.main(["score", *common, "--device", "cpu", "--output-dir", str(tmp_path / "port"),
                      "--checkpoint", str(ckpt), *port_args]) == 0
    want = {r["mutant"]: float(r[column]) for r in _read(tmp_path / "jax" / f"{dms_id}.csv")}
    got = _read(tmp_path / "port" / f"{dms_id}.csv")
    assert list(got[0]) == ["mutant", "DMS_score", "mutated_sequence", column]
    assert [r["mutant"] for r in got] == list(want)
    values = np.asarray([float(r[column]) for r in got])
    assert np.isfinite(values).all() and len(set(values)) > len(values) // 2
    np.testing.assert_allclose(values, [want[r["mutant"]] for r in got], atol=1e-5, rtol=0)


# the structure-conditioned PLMs, each on one weight set through both CLIs
# (--device cpu, float32): the port reads a state dict file in the published
# layout through --checkpoint (ProSST's HF names, MULAN's
# StructEsmForMaskedLM, MIF's own), the JAX CLI gets the same weights through
# its patched init; the legacy methods' inits are patched on both sides, and
# MIF's presets are narrowed to 3 x 32 float32 on both. (port arguments, JAX
# arguments, column)
STRUCTURE_PLM_RUNS = {
    "prosst": ([], ["--checkpoint", "prosst_tiny"], "prosst_tiny_score"),
    "prosst_additive": (["--extra", "method=additive", "esm_checkpoint=esm2_tiny", "k_structure=8"],
                        ["--extra", "method=additive", "esm_checkpoint=esm2_tiny",
                         "k_structure=8"], "ProSST_8_score"),
    "venusrem": (["--extra", "struc_seq_aln_dir=aln"], ["--extra", "struc_seq_aln_dir=aln"],
                 "VenusREM_score"),
    "venusrem_esm": (["--extra", "method=esm", "esm_checkpoint=esm2_tiny:ckpt"],
                     ["--extra", "method=esm", "esm_checkpoint=esm2_tiny:ckpt"], "VenusREM_score"),
    "mulan": ([], [], "MULAN_score"),
    "mulan_additive": (["--checkpoint", "esm2_tiny", "--extra", "method=additive"],
                       ["--checkpoint", "esm2_tiny", "--extra", "method=additive"], "MULAN_score"),
    "mif": ([], [], "MIF_score"),
    "mif_st": ([], [], "MIF_ST_score"),
}


@pytest.mark.parametrize("run", sorted(STRUCTURE_PLM_RUNS))
def test_structure_plm_scorers_match_the_jax_cli(tmp_path, monkeypatch, run):
    import dataclasses

    from proteingym_tpu.models import carp as jc
    from proteingym_tpu.models import mulan as jm
    from proteingym_tpu.models import prosst as jp
    from proteingym_tpu.models import structure_plms as jsp
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone
    from proteingym_tpu_torch.models import mulan as tm
    from proteingym_tpu_torch.models import prosst as tp
    from proteingym_tpu_torch.models import structure_plms as tsp
    from tests import test_torch_mulan, test_torch_prosst, test_torch_structure_plms

    ref, dms_dir, (dms_id,) = _write_assays(tmp_path, n_assays=1)
    seq = next(r for r in csv.DictReader(open(ref)))["target_seq"]
    backbone = synthetic_helix_backbone(len(seq), seed=2)
    backbone[:, 1] += 0.05 * np.random.RandomState(2).randn(len(seq), 3)
    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", backbone, seq)
    port_args, jax_args, column = STRUCTURE_PLM_RUNS[run]
    model = run.split("_")[0] if run != "mif_st" else run
    ckpt = tmp_path / "weights.pt"
    state = None
    if run in ("prosst", "venusrem"):
        sd = test_torch_prosst.hf_state(seed=5)
        params, _ = test_torch_prosst.both(sd)
        monkeypatch.setattr(jp, "prosst_init_params", lambda rng, c: params)
        state = sd
        rows = ["".join(np.random.default_rng(i).choice(list(AA), len(seq))) for i in range(6)]
        (tmp_path / "aln").mkdir()
        (tmp_path / "aln" / f"{dms_id}.fasta").write_text(
            "".join(f">r{i}\n{r}\n" for i, r in enumerate(rows)))
    elif run == "prosst_additive":
        params, net = test_torch_prosst.legacy_additive(seed=5)
        monkeypatch.setattr(jp, "prosst_init", lambda rng, c, k_structure: params)
        monkeypatch.setattr(tp, "prosst_init", lambda c, k_structure, seed, device: net)
    elif run == "venusrem_esm":
        _save_checkpoint(ckpt, 5)
    elif run == "mulan":
        tiny = tm.PRESETS["mulan_tiny"]
        sd = test_torch_mulan.struct_esm_state(tiny, seed=5)
        with jax.enable_x64(False):
            params = jm.convert_torch_state_dict(sd, jm.MulanConfig(
                esm=dataclasses.replace(test_torch_mulan.JC.esm, num_layers=6, embed_dim=320,
                                        num_heads=20)))
        monkeypatch.setattr(jm, "init_params", lambda rng, c: params)
        state = sd
    elif run == "mulan_additive":
        from proteingym_tpu_torch.models import esm2 as tesm

        with jax.enable_x64(False):
            params = jax.device_get(jsp.mulan_init(jax.random.PRNGKey(5),
                                                   test_torch_prosst.JESM))
        net = tsp.AngleConditionedEsm(tesm.load_fair_esm_state_dict(
            tesm.params_from_jax(params, tesm.PRESETS["esm2_tiny"]), tesm.PRESETS["esm2_tiny"],
            device="cpu"))
        adapter = params["angle_adapter"]
        net.angle_adapter.weight.data.copy_(torch.from_numpy(np.array(adapter["w"]).T))
        net.angle_adapter.bias.data.copy_(torch.from_numpy(np.array(adapter["b"])))
        monkeypatch.setattr(jsp, "mulan_init", lambda rng, c: params)
        monkeypatch.setattr(tsp, "mulan_init", lambda c, seed, device: net)
    else:
        narrow = test_torch_structure_plms
        params, net = narrow.native(seed=5)
        monkeypatch.setattr(jc, "CarpConfig",
                            lambda name, *a, **k: dataclasses.replace(narrow.JCFG, name=name))
        monkeypatch.setattr(jsp, "mif_init", lambda rng, c, feat_dim: params)
        monkeypatch.setattr(tsp, "MIF_PRESETS", {v: dataclasses.replace(narrow.TCFG, name=v)
                                                 for v in ("mif", "mif_st")})
        state = net.state_dict()
    if state is not None:
        torch.save({k: torch.as_tensor(v) for k, v in state.items()}, ckpt)
        port_args = ["--checkpoint", str(ckpt), *port_args]
    fix = lambda args: [a.replace("=aln", f"={tmp_path / 'aln'}").replace(":ckpt", f":{ckpt}")
                        for a in args]  # noqa: E731
    common = ["--model", model, "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
              "--structure-dir", str(tmp_path / "pdb"), "--batch-size", "8", "--quiet"]
    with jax.enable_x64(False):
        assert jcli.main(["--platform", "cpu", "score", *common, "--output-dir",
                          str(tmp_path / "jax"), *fix(jax_args)]) == 0
    assert tcli.main(["score", *common, "--device", "cpu", "--output-dir", str(tmp_path / "port"),
                      *fix(port_args)]) == 0
    want = {r["mutant"]: float(r[column]) for r in _read(tmp_path / "jax" / f"{dms_id}.csv")}
    got = _read(tmp_path / "port" / f"{dms_id}.csv")
    assert list(got[0]) == ["mutant", "DMS_score", "mutated_sequence", column]
    assert [r["mutant"] for r in got] == list(want)
    values = np.asarray([float(r[column]) for r in got])
    assert np.isfinite(values).all() and len(set(values)) > len(values) // 2
    np.testing.assert_allclose(values, [want[r["mutant"]] for r in got], atol=1e-4, rtol=0)


# structure slice C through both CLIs (--device cpu, float32) on one assay
# with a written PDB whose B-factors put residues on both sides of S3F's
# pLDDT threshold of 70, an alignment of the whole target, and for the
# surface variants a seeded surface .npz. ProtSSN: the port reads published
# files named protssn_k{k}_h16.pt (their k from the name), the JAX CLI the
# same weights through its patched presets and init; S2F / S3F: the port
# reads a published-names file, the JAX CLI the same weights through its
# patched init; AIDO: a tiny float32 config on both sides. (scorer,
# arguments of both, column)
SLICE_C_RUNS = {
    "protssn": ("protssn", ["--checkpoint", "k10"], "ProtSSN_score"),
    "protssn_ensemble": ("protssn", ["--checkpoint", "k10,k5"], "ProtSSN_ensemble"),
    "s2f": ("s2f", [], "S2F_score"),
    "s3f": ("s3f", ["--extra", "surface_dir=surf"], "S3F_score"),
    "s3f_msa": ("s3f_msa", ["--extra", "surface_dir=surf"], "S3F_MSA_score"),
    "aido": ("aido", [], "AIDO_score"),
    "aido_msa": ("aido", [], "AIDO_score"),
}


def _slice_c_world(tmp_path, msa):
    from proteingym_tpu_torch.data.structures import synthetic_helix_backbone, write_pdb_backbone

    ref, dms_dir, (dms_id,) = _write_assays(tmp_path, n_assays=1)
    seq = next(r for r in csv.DictReader(open(ref)))["target_seq"]
    backbone = synthetic_helix_backbone(len(seq), seed=2)
    backbone[:, 1] += 0.05 * np.random.RandomState(2).randn(len(seq), 3)
    plddt = np.where(np.arange(len(seq)) % 4 == 1, 55.0, 88.0)
    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", backbone, seq, bfactors=plddt)
    rs = np.random.RandomState(3)
    (tmp_path / "surf").mkdir()
    ca = backbone[:, 1]
    np.savez(tmp_path / "surf" / "P0.npz",
             position=(ca[rs.randint(0, len(seq), 60)] + 2 * rs.randn(60, 3)).astype(np.float32),
             feature=rs.randn(60, 10).astype(np.float32))
    if msa:
        (tmp_path / "msa").mkdir()
        rows = [seq] + ["".join(c if rs.rand() < 0.7 else rs.choice(list(AA + "-")) for c in seq)
                        for _ in range(11)]
        (tmp_path / "msa" / "SYN.a2m").write_text(
            f">SYN/1-{len(seq)}\n{rows[0]}\n" + "".join(f">h{i}\n{r}\n"
                                                       for i, r in enumerate(rows[1:])))
        with open(ref, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                        "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
            w.writerow([dms_id, f"{dms_id}.csv", "P0", seq, len(seq), "SYN.a2m", 1, len(seq),
                        0.2, "SYN.npy"])
    return ref, dms_dir, dms_id, seq


@pytest.mark.parametrize("run", sorted(SLICE_C_RUNS))
def test_structure_slice_c_scorers_match_the_jax_cli(tmp_path, monkeypatch, run):
    import dataclasses

    from proteingym_tpu.models import protssn as jp
    from proteingym_tpu.models import s3f as js
    from proteingym_tpu.models import structure_plms as jsp
    from proteingym_tpu_torch.models import s3f as ts
    from proteingym_tpu_torch.models import structure_plms as tsp
    from tests import test_torch_aido, test_torch_protssn, test_torch_s3f

    model, args, column = SLICE_C_RUNS[run]
    msa = run in ("s3f_msa", "aido_msa")
    ref, dms_dir, dms_id, seq = _slice_c_world(tmp_path, msa)
    esm = _save_checkpoint(tmp_path / "esm.pt", 5)
    port_args = jax_args = list(args)
    if model == "protssn":
        from proteingym_tpu_torch.models import protssn as tp

        stats = test_torch_protssn._stats(3)
        torch.save({k: torch.from_numpy(v) for k, v in stats.items()}, tmp_path / "stats.pt")
        presets, params, files = {}, {}, {}
        for i, k in enumerate((10, 5)):
            name = f"protssn_k{k}_h16"
            c = tp.ProtssnEgnnConfig(name=name, input_dim=128, m_dim=16, n_layers=2,
                                     k_neighbors=k)
            sd = test_torch_protssn.published_state(c, seed=11 + i)
            files[f"k{k}"] = tmp_path / f"{name}.pt"
            torch.save(sd, files[f"k{k}"])
            presets[name] = jp.ProtssnEgnnConfig(name=name, input_dim=128, m_dim=16, n_layers=2,
                                                 k_neighbors=k)
            with jax.enable_x64(False):
                params[name] = jp.convert_torch_state_dict(sd, presets[name])
        monkeypatch.setattr(jp, "PROTSSN_PRESETS", presets)
        monkeypatch.setattr(jp, "init_egnn_params", lambda rng, c: params[c.name])
        # the JAX stack under one jit: op by op it takes seconds
        monkeypatch.setattr(jp, "egnn_log_probs", jax.jit(jp.egnn_log_probs, static_argnums=1))
        specs = args[1].split(",")
        port_args = ["--checkpoint", ",".join(str(files[x]) for x in specs)]
        jax_args = ["--checkpoint", ",".join(f"protssn_{x}_h16" for x in specs)]
        extra = ["--extra", f"esm_checkpoint=esm2_tiny:{esm}", f"norm_stats={tmp_path}/stats.pt"]
        port_args, jax_args = port_args + extra, jax_args + extra
    elif model in ("s2f", "s3f", "s3f_msa"):
        tiny = {name: dataclasses.replace(c, node_in=128) for name, c in ts.S3F_PRESETS.items()
                if name.endswith("_tiny")}
        monkeypatch.setattr(ts, "S3F_PRESETS", {**ts.S3F_PRESETS, **tiny})
        c = tiny["s2f_tiny" if model == "s2f" else "s3f_tiny"]
        sd = test_torch_s3f.published_state(c, seed=12, prefix="")
        with jax.enable_x64(False):
            params = js.convert_torch_state_dict_gvpgnn(sd, js.GvpGnnConfig(**dataclasses.asdict(c)))
        monkeypatch.setattr(js, "gvpgnn_init", lambda rng, cfg: params)
        monkeypatch.setattr(js, "gvpgnn_node_logits",
                            jax.jit(js.gvpgnn_node_logits, static_argnums=1))
        torch.save(sd, tmp_path / "s3f.pt")
        extra = ["--extra", f"esm_checkpoint=esm2_tiny:{esm}"]
        if "--extra" in args:
            extra.append(args[args.index("--extra") + 1].replace("=surf", f"={tmp_path}/surf"))
        port_args, jax_args = ["--checkpoint", str(tmp_path / "s3f.pt")] + extra, extra
    else:
        params, net = test_torch_aido.native()
        monkeypatch.setattr(jsp, "AidoConfig", lambda: test_torch_aido.JCFG)
        monkeypatch.setattr(jsp, "aido_init", lambda rng, c: params)
        monkeypatch.setattr(tsp, "AidoConfig", lambda: test_torch_aido.TCFG)
        monkeypatch.setattr(tsp, "aido_init", lambda c, seed, device: net)
    common = ["--model", model, "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
              "--structure-dir", str(tmp_path / "pdb"), "--batch-size", "8", "--quiet"]
    if msa:
        common += ["--msa-dir", str(tmp_path / "msa"), "--weights-dir", str(tmp_path / "w")]
    # the port first: it writes the alignment's weights, which the JAX CLI reads
    assert tcli.main(["score", *common, "--device", "cpu", "--output-dir", str(tmp_path / "port"),
                      *port_args]) == 0
    with jax.enable_x64(False):
        assert jcli.main(["--platform", "cpu", "score", *common, "--output-dir",
                          str(tmp_path / "jax"), *jax_args]) == 0
    want = {r["mutant"]: float(r[column]) for r in _read(tmp_path / "jax" / f"{dms_id}.csv")}
    got = _read(tmp_path / "port" / f"{dms_id}.csv")
    assert list(got[0]) == ["mutant", "DMS_score", "mutated_sequence", column]
    assert [r["mutant"] for r in got] == list(want)
    values = np.asarray([float(r[column]) for r in got])
    assert np.isfinite(values).all() and len(set(values)) > len(values) // 2
    np.testing.assert_allclose(values, [want[r["mutant"]] for r in got], atol=1e-4, rtol=0)
    assert (tmp_path / "w" / "SYN.npy").exists() == msa


def test_protssn_ensemble_lists(tmp_path):
    from proteingym_tpu_torch.data.reference import load_reference
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    ref, _, ids = _write_assays(tmp_path, n_assays=1)
    ctx = tscorers.ScoreContext(record=load_reference(ref)[ids[0]], mutants=[],
                                device=torch.device("cpu"))
    for spec, extra, match in (("protssn_k10_h512,", {}, "empty entry"),
                               ("protssn_k10_h512, ,protssn_tiny", {}, "empty entry"),
                               ("protssn_tiny,protssn_tiny", {"norm_stats": "a.pt,b.pt,c.pt"},
                                "2 checkpoints but 3 norm_stats")):
        ctx.checkpoint, ctx.extra = spec, extra
        with pytest.raises(ValueError, match=match):
            tscorers.SCORERS["protssn"](ctx)


# the VESPA family and the supervised scorers through both CLIs (--device
# cpu, float32), each on one weight set: the port reads the published
# torch files (an HF ProtT5 pytorch_model.bin, a prott5cons .pt, VespaG's
# state_dict_v2.pt), the JAX CLI the same weights from orbax directories or
# its patched inits; ProteinNPT's training replays the JAX run's draws.
# (scorer, extra arguments of both, columns)
SUPERVISED_RUNS = {
    "vespa_full": ("vespa", ["vespa_mode=full"], ["VESPA_score"]),
    "vespa_light": ("vespa", ["vespa_mode=light"], ["VESPA_score"]),
    "vespa_logodds": ("vespa", ["vespa_mode=logodds"], ["VESPA_score"]),
    "vespag_checkpoint": ("vespag", [], ["VespaG_score"]),
    "vespag_teacher": ("vespag", ["train_steps=20"], ["VespaG_score"]),
    "ohe_ridge": ("ohe_ridge", [], [f"OHE_ridge_{s}" for s in SUPERVISED_SCHEMES]),
    "ohe_ridge_aug": ("ohe_ridge", ["aug_col=zero_shot_score"],
                      [f"OHE_ridge_aug_{s}" for s in SUPERVISED_SCHEMES]),
    "embeddings_ridge": ("embeddings_ridge", [], [f"Emb_ridge_{s}" for s in SUPERVISED_SCHEMES]),
    "proteinnpt": ("proteinnpt", ["npt_steps=3", "npt_dim=8", "npt_layers=1"],
                   [f"ProteinNPT_{s}" for s in SUPERVISED_SCHEMES]),
    "kermut": ("kermut", ["gp_steps=5", "n_orders=1"], [f"kermut_{s}" for s in SUPERVISED_SCHEMES]),
}


def _jax_checkpoint_dirs(monkeypatch, trees):
    """The JAX CLI reads these scorers' weights from orbax directories
    (``<dir>/params`` + ``config.json``): each ``{dir: (params, config)}``
    gets its directory, and ``restore_pytree`` hands back the params from
    memory (orbax's set-up costs seconds a test)."""
    from proteingym_tpu.pipeline import checkpoints as jckpt

    for path, (_, config) in trees.items():
        (path / "params").mkdir(parents=True)
        if config is not None:
            (path / "config.json").write_text(json.dumps(config))
    by_dir = {str((path / "params").resolve()): params for path, (params, _) in trees.items()}
    monkeypatch.setattr(jckpt, "restore_pytree", lambda p: by_dir[str(Path(p).resolve())])


def _supervised_world(tmp_path, folds=False):
    """The slice C world (assay, helix PDB, alignment of the whole target)
    with a zero-shot column in the assay, and with ``folds`` published fold
    columns of two folds each (the slow JAX sides compile once a fold)."""
    ref, dms_dir, dms_id, seq = _slice_c_world(tmp_path, msa=True)
    rows = _read(dms_dir / f"{dms_id}.csv")
    zs = np.random.RandomState(8).randn(len(rows))
    n = len(rows)
    fold_cols = {s: [i % 2 for i in range(n)] for s in SUPERVISED_SCHEMES} if folds else {}
    with open(dms_dir / f"{dms_id}.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mutant", "DMS_score", "zero_shot_score", *fold_cols])
        w.writerows([r["mutant"], r["DMS_score"], f"{z:.5f}", *(c[i] for c in fold_cols.values())]
                    for i, (r, z) in enumerate(zip(rows, zs)))
    return ref, dms_dir, dms_id, seq


def _memoised(fn):
    """``fn`` with its results kept by the bytes of its array arguments (and
    the rest by value): a deterministic JAX fit on the same fold runs once."""
    cache = {}

    def key(x):
        if isinstance(x, (tuple, list)):
            return tuple(key(v) for v in x)
        if isinstance(x, dict):
            return tuple((k, key(v)) for k, v in sorted(x.items()))
        if isinstance(x, (np.ndarray, jax.Array)):
            x = np.asarray(x)
            return (x.dtype.str, x.shape, x.tobytes())
        try:
            return hash(x), x
        except TypeError:
            return id(x)

    def wrapper(*args, **kwargs):
        k = (key(args), key(sorted(kwargs.items())))
        if k not in cache:
            cache[k] = fn(*args, **kwargs)
        return cache[k]
    return wrapper


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("run", sorted(SUPERVISED_RUNS))
def test_supervised_and_vespa_scorers_match_the_jax_cli(tmp_path, monkeypatch, run):
    import dataclasses

    from proteingym_tpu.models import esm2 as jesm
    from proteingym_tpu.models import kermut as jk
    from proteingym_tpu.models import prot_t5 as jt5
    from proteingym_tpu.models import protein_mpnn as jm
    from proteingym_tpu.models import protein_npt as jnpt
    from proteingym_tpu.models import vespa_heads as jvh
    from proteingym_tpu.models import vespag as jvg
    from proteingym_tpu_torch.models import protein_mpnn as tm
    from proteingym_tpu_torch.models import protein_npt as tnpt
    from proteingym_tpu_torch.models import vespag as tvg
    from tests import test_torch_prot_t5, test_torch_protein_npt, test_torch_vespa

    model, extra, columns = SUPERVISED_RUNS[run]
    folds = model in ("proteinnpt", "kermut", "embeddings_ridge")
    ref, dms_dir, dms_id, seq = _supervised_world(tmp_path, folds=folds)
    esm = _save_checkpoint(tmp_path / "esm.pt", 5)
    esm_sd = fair_esm_state(tesm.PRESETS["esm2_tiny"], 5)
    port_extra, jax_extra, port_args, jax_args = list(extra), list(extra), [], []
    if model == "vespa":
        sd = test_torch_prot_t5.hf_state(test_torch_prot_t5.TINY, seed=7, decoder_layers=2)
        (tmp_path / "t5").mkdir()
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   tmp_path / "t5" / "pytorch_model.bin")
        cons = {"0.weight": np.random.RandomState(1).randn(32, 64, 7, 1).astype(np.float32) * .05,
                "0.bias": np.zeros(32, np.float32),
                "3.weight": np.random.RandomState(2).randn(9, 32, 7, 1).astype(np.float32) * .1,
                "3.bias": np.zeros(9, np.float32)}
        torch.save({k: torch.from_numpy(v) for k, v in cons.items()}, tmp_path / "cons.pt")
        with jax.enable_x64(False):
            jconfig = jt5.config_from_state_dict(sd)
            _jax_checkpoint_dirs(monkeypatch, {
                tmp_path / "t5j": (jt5.convert_torch_state_dict(sd, jconfig), {
                    k: v for k, v in dataclasses.asdict(jconfig).items() if k != "dtype"}),
                tmp_path / "consj": (jvh.convert_conscnn_state_dict(cons), None)})
        # the JAX T5 under one jit a function (op by op it takes seconds)
        monkeypatch.setattr(jt5, "apply", jax.jit(jt5.apply, static_argnums=1))
        monkeypatch.setattr(jt5, "decoder_apply", jax.jit(jt5.decoder_apply, static_argnums=1))
        port_extra += [f"prot_t5_checkpoint={tmp_path / 't5'}", f"conscnn_checkpoint={tmp_path}/cons.pt"]
        jax_extra += [f"prot_t5_checkpoint={tmp_path / 't5j'}",
                      f"conscnn_checkpoint={tmp_path / 'consj'}"]
    elif run == "vespag_checkpoint":
        sd = test_torch_vespa.vespag_state("fnn", 128)
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "vg.pt")
        with jax.enable_x64(False):
            params = jvg.convert_torch_state_dict(sd)
        _jax_checkpoint_dirs(monkeypatch, {tmp_path / "vgj": (
            {k: v for k, v in params.items() if k != "arch"}, {"arch": "fnn"})})
        port_args, jax_args = ["--checkpoint", str(tmp_path / "vg.pt")], [
            "--checkpoint", str(tmp_path / "vgj")]
        port_extra = jax_extra = extra + [f"esm_checkpoint=esm2_tiny:{esm}"]
    elif run == "vespag_teacher":
        with jax.enable_x64(False):
            params = jvg.init_params(jax.random.PRNGKey(0), jvg.VespagConfig(embed_dim=128))
        start = tvg.params_from_jax({k: v if k == "arch" else jax.tree_util.tree_map(
            np.asarray, v) for k, v in params.items()})
        monkeypatch.setattr(tvg, "init_fnn", lambda d, seed, device: tvg.load_state_dict(
            start, device=device))
        port_extra = jax_extra = extra + [f"esm_checkpoint=esm2_tiny:{esm}"]
    elif model == "embeddings_ridge":
        with jax.enable_x64(False):
            params = jesm.convert_torch_state_dict(esm_sd, jesm.PRESETS["esm2_tiny"])
        monkeypatch.setattr(jesm, "init_params", lambda rng, c: params)
        port_args, jax_args = ["--checkpoint", f"esm2_tiny:{esm}"], ["--checkpoint", "esm2_tiny"]
    elif model == "proteinnpt":
        real_train = tnpt.train

        def jax_init(c, seed, device):
            with jax.enable_x64(False):
                p = jnpt.init_params(jax.random.PRNGKey(seed),
                                     jnpt.ProteinNptConfig(**dataclasses.asdict(c)))
            return tnpt.load_state_dict(tnpt.params_from_jax(jax.tree_util.tree_map(
                np.asarray, p)), c, device=device)

        draws = _memoised(test_torch_protein_npt.jax_draws)

        def replayed(model_, c, feats, targets, aux=None, seed=0, draws_=None):
            return real_train(model_, c, feats, targets, aux=aux, seed=seed,
                              draws=draws(c, len(targets), c.steps, seed))
        monkeypatch.setattr(jnpt, "init_params",
                            _memoised(jax.jit(jnpt.init_params, static_argnums=1)))
        monkeypatch.setattr(tnpt, "init_random", jax_init)
        monkeypatch.setattr(tnpt, "train", replayed)
        monkeypatch.setattr(jnpt, "train", _memoised(jnpt.train))
        monkeypatch.setattr(jnpt, "predict", _memoised(jnpt.predict))
    elif model == "kermut":
        real_init = tm.init_random
        with jax.enable_x64(False):
            jparams = jm.init_params(jax.random.PRNGKey(0), jm.MpnnConfig(
                name="kermut_probs", hidden_dim=64, edge_features=64, k_neighbors=16))

        def jax_mpnn(config, seed=0, device="cuda"):
            if config.name != "kermut_probs":
                return real_init(config, seed=seed, device=device)
            return tm.load_state_dict(tm.params_from_jax(jax.tree_util.tree_map(
                np.asarray, jparams), config), config, device=device)
        monkeypatch.setattr(tm, "init_random", jax_mpnn)
        monkeypatch.setattr(jk, "fit", _memoised(jk.fit))
        monkeypatch.setattr(jk, "predict", _memoised(jk.predict))
        monkeypatch.setattr(jm, "init_params", lambda rng, c: jparams)  # drawn once, above
    common = ["--model", model, "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
              "--structure-dir", str(tmp_path / "pdb"), "--msa-dir", str(tmp_path / "msa"),
              "--weights-dir", str(tmp_path / "w"), "--batch-size", "8", "--quiet"]
    assert tcli.main(["score", *common, "--device", "cpu", "--output-dir", str(tmp_path / "port"),
                      *port_args, *(["--extra", *port_extra] if port_extra else [])]) == 0
    with jax.enable_x64(False):
        assert jcli.main(["--platform", "cpu", "score", *common, "--output-dir",
                          str(tmp_path / "jax"), *jax_args,
                          *(["--extra", *jax_extra] if jax_extra else [])]) == 0
    want = _read(tmp_path / "jax" / f"{dms_id}.csv")
    got = _read(tmp_path / "port" / f"{dms_id}.csv")
    assert list(got[0]) == ["mutant", "DMS_score", "zero_shot_score",
                            *(SUPERVISED_SCHEMES if folds else []), "mutated_sequence",
                            *columns] == list(want[0])
    assert [r["mutant"] for r in got] == [r["mutant"] for r in want]
    atol = 1e-3 if model == "kermut" else 2e-4
    for column in columns:
        values = np.asarray([float(r[column]) for r in got])
        # the ridges predict one value per held-out position of the modulo folds
        assert np.isfinite(values).all() and len(set(values)) > 3, column
        np.testing.assert_allclose(values, [float(r[column]) for r in want], atol=atol, rtol=0,
                                   err_msg=column)


@pytest.mark.usefixtures("one_thread")
def test_supervised_score_merge_evaluate_match_the_jax_cli(tmp_path):
    """supervised-score (OHE_ridge) -> merge-supervised ->
    evaluate-supervised through both CLIs: the score files within the
    ridge's float32 noise; merged from the same score files, the merged
    files within 2e-12 (pandas' CSV float parser is not correctly rounded);
    evaluated from the same long table, the metric files equal byte for
    byte."""
    from tests.test_torch_supervised import assert_same_csv

    ref, dms_dir, ids = _write_assays(tmp_path, n_assays=2)
    with open(ref) as f:
        rows = list(csv.reader(f))
    with open(ref, "w", newline="") as f:  # the evaluation's categories
        w = csv.writer(f)
        w.writerow(rows[0] + ["taxon", "coarse_selection_type", "MSA_Neff_L_category"])
        w.writerows(r + [["Human", "Virus"][i], ["Activity", "Stability"][i], "Low"]
                    for i, r in enumerate(rows[1:]))
    for dms_id in ids:  # the published layout: mutated_sequence and two-fold columns
        assay = _read(dms_dir / f"{dms_id}.csv")
        seq = next(r for r in csv.DictReader(open(ref)) if r["DMS_id"] == dms_id)["target_seq"]
        with open(dms_dir / f"{dms_id}.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["mutant", "mutated_sequence", "DMS_score", *SUPERVISED_SCHEMES])
            w.writerows([r["mutant"], tcli.apply_mutant(seq, r["mutant"]), r["DMS_score"],
                         *[i % 2] * 3] for i, r in enumerate(assay))
    config = tmp_path / "config.json"  # two models over one set of files, and a missing one
    config.write_text(json.dumps({"model_list_supervised_substitutions_DMS": {
        name: {"input_score_name": "y_pred", "location": location, "key": "mutant",
               "label_name": "DMS_score", "model_type": "Supervised"}
        for name, location in (("OHE_ridge", "ohe_ridge"), ("OHE_again", "ohe_ridge"),
                               ("Absent", "absent"))}}))
    for side in ("jax", "port"):
        root = tmp_path / side
        args = ["supervised-score", "--model", "OHE_ridge", "--dms-reference", str(ref),
                "--dms-dir", str(dms_dir), "--output-dir", str(root / "scores")]
        with jax.enable_x64(False):
            rc = (tcli.main(args + ["--device", "cpu"]) if side == "port"
                  else jcli.main(["--platform", "cpu", *args]))
        assert rc == 0
        args = ["merge-supervised", "--dms-reference", str(ref), "--dms-dir", str(dms_dir),
                "--scores-root", str(tmp_path / "jax" / "scores"), "--config", str(config),
                "--output-dir", str(root / "merged")]
        assert (tcli.main(args + ["--device", "cpu"]) if side == "port"
                else jcli.main(["--platform", "cpu", *args])) == 0
        args = ["evaluate-supervised", "--dms-reference", str(ref), "--input-scoring-file",
                str(tmp_path / "jax" / "merged" / "merged_scores_substitutions_DMS.csv"),
                "--output-dir", str(root / "bench"), "--bootstrap-samples", "100", "--no-html"]
        assert (tcli.main(args) if side == "port" else jcli.main(["--platform", "cpu", *args])) == 0
    scores = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.csv")
                    if "bench" not in p.parts)
    assert len(scores) == 3 * 2 + 3 * 2 + 1  # score files, merged files, the long table
    for rel in scores:
        assert_same_csv(tmp_path / "port" / rel, tmp_path / "jax" / rel, atol=2e-4 if "scores"
                        in rel.parts else 2e-12)
    bench = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax" / "bench").rglob("*"))
    assert bench and bench == sorted(p.relative_to(tmp_path / "port")
                                     for p in (tmp_path / "port" / "bench").rglob("*"))
    for rel in bench:
        if rel.suffix == ".csv":
            assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


def test_checkpoint_root_routes_each_assay(tmp_path):
    """score --checkpoint-root: each assay reads DIR/<EVE_model_path> of its
    reference row (a plmc model here), a row without one is skipped with
    task_missing_input; the scores equal the JAX CLI's."""
    from proteingym_tpu_torch.models import potts as tpotts
    from proteingym_tpu_torch.pipeline.scorers import POTTS_ALPHABET
    from tests.test_torch_gemme import write_baseline_world

    write_baseline_world(tmp_path)
    ref = tmp_path / "ref.csv"
    rows = list(csv.DictReader(open(ref)))
    ctx = tcli.ScoreContext(record=tcli.load_reference(ref)[0], mutants=[],
                            device=torch.device("cpu"), msa_dir=tmp_path / "msa")
    msa = ctx.load_msa()
    model = tpotts.train_potts_plm(msa.matrix, msa.weights, POTTS_ALPHABET,
                                   np.asarray(msa.focus_cols) + 4, msa.focus_seq_trimmed,
                                   steps=5, device="cpu")
    (tmp_path / "models" / "sub").mkdir(parents=True)
    tpotts.write_plmc_model(model, tmp_path / "models" / "sub" / "fam.model")
    other = dict(rows[0], DMS_id="FAM_OTHER")
    with open(ref, "w", newline="") as f:
        w = csv.DictWriter(f, list(rows[0]) + ["EVE_model_path"])
        w.writeheader()
        w.writerow(dict(rows[0], EVE_model_path="sub/fam.model"))
        w.writerow(dict(other, EVE_model_path=""))
    common = ["--model", "potts", "--dms-reference", str(ref), "--dms-dir", str(tmp_path / "dms"),
              "--checkpoint-root", str(tmp_path / "models"), "--quiet"]
    assert tcli.main(["score", *common, "--device", "cpu", "--output-dir",
                      str(tmp_path / "port")]) == 0
    assert jcli.main(["--platform", "cpu", "score", *common, "--output-dir",
                      str(tmp_path / "jax")]) == 0
    dms_id = rows[0]["DMS_id"]
    got, want = _read(tmp_path / "port" / f"{dms_id}.csv"), _read(tmp_path / "jax" / f"{dms_id}.csv")
    assert [r["mutant"] for r in got] == [r["mutant"] for r in want]
    np.testing.assert_allclose([float(r["EVmutation_score"] or "nan") for r in got],
                               [float(r["EVmutation_score"] or "nan") for r in want],
                               atol=1e-5, rtol=0, equal_nan=True)
    assert not (tmp_path / "port" / "FAM_OTHER.csv").exists()
    events = [json.loads(x) for x in (tmp_path / "port" / "events.jsonl").read_text().splitlines()]
    assert [e["task"] for e in events if e["event"] == "task_missing_input"] == ["potts/FAM_OTHER"]
