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
