"""The slice as a whole: the JAX CLI and the port's CLI score the same
assays with the same fair-esm checkpoint, and their score columns agree."""

import csv
import json

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
    assert len(SCORERS) == 26


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
                                   "esmc", "esm3", "xtrimopglm", "carp"])
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
