"""The PoET slice as a whole: the port's CLI (``score --model poet --device
cpu``) on a synthetic assay, MSA and reference file writes the score, the
manifest, the event log and the weights cache, and its scores match the JAX
``poet`` scorer's on the same records, weights and bridged parameters."""

import csv
import json

import numpy as np
import pandas as pd
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.data.reference import load_reference as jload_reference
from proteingym_tpu.models import poet as jpoet
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu_torch.models import poet as tpoet
from proteingym_tpu_torch.pipeline import cli as tcli
from tests.test_torch_poet import poet_state

ATOL = 1e-4  # float32 on both sides
AA = "ACDEFGHIKLMNPQRSTVWY"
EXTRA = ["max_context_tokens=150", "n_context_samples=2"]


def _write_world(root, length=24, n_seqs=40):
    rng = np.random.default_rng(0)
    focus = "".join(rng.choice(list(AA), length))
    (root / "msa").mkdir()
    (root / "dms").mkdir()
    with open(root / "msa" / "FAM.a2m", "w") as f:
        f.write(f">FAM/1-{length}\n{focus}\n")
        for i in range(1, n_seqs):
            s = [c if rng.random() > 0.25 else rng.choice(list(AA)) for c in focus]
            for p in np.nonzero(rng.random(length) < 0.15)[0]:
                s[p] = "-"
            f.write(f">hom{i}/1-{length}\n{''.join(s)}\n")
    mutants = [f"{focus[p]}{p + 1}{a}" for p in range(0, length, 3) for a in "GW" if a != focus[p]]
    mutants.append(f"{focus[0]}1K:{focus[5]}6P")
    with open(root / "dms" / "FAM_TEST.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mutant", "DMS_score"])
        w.writerows([m, f"{rng.standard_normal():.4f}"] for m in mutants)
    with open(root / "ref.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
        w.writerow(["FAM_TEST", "FAM_TEST.csv", "P1", focus, length, "FAM.a2m", 1, length,
                    0.2, "FAM_theta_0.2.npy"])
    return mutants


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_port_cli_scores_poet_like_the_jax_scorer(tmp_path, monkeypatch):
    mutants = _write_world(tmp_path)
    tiny = tpoet.POET_PRESETS["poet_tiny"]
    sd = poet_state(tiny, seed=3)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "poet.pt")
    out = tmp_path / "out"
    rc = tcli.main([
        "score", "--model", "poet", "--checkpoint", f"poet_tiny:{tmp_path / 'poet.pt'}",
        "--device", "cpu", "--msa-dir", str(tmp_path / "msa"),
        "--weights-dir", str(tmp_path / "w_port"), "--dms-reference", str(tmp_path / "ref.csv"),
        "--dms-dir", str(tmp_path / "dms"), "--output-dir", str(out), "--batch-size", "4",
        "--quiet", "--extra", *EXTRA,
    ])
    assert rc == 0
    rows = _read(out / "FAM_TEST.csv")
    assert list(rows[0]) == ["mutant", "DMS_score", "mutated_sequence", "PoET_score"]
    assert [r["mutant"] for r in rows] == mutants
    got = np.asarray([float(r["PoET_score"]) for r in rows])
    assert np.isfinite(got).all() and len(set(got)) > 1
    manifest = [json.loads(line) for line in (out / "manifest.jsonl").read_text().splitlines()]
    assert [(m["task"], m["status"]) for m in manifest] == [("poet/FAM_TEST", "done")]
    events = [json.loads(line)["event"] for line in (out / "events.jsonl").read_text().splitlines()]
    assert "throughput_summary" in events
    assert (tmp_path / "w_port" / "FAM_theta_0.2.npy").exists()

    # the JAX scorer on the same record, with the JAX bridge of the same weights
    jconfig = jpoet.PoetConfig("poet_tiny", 2, 64, 4, 128, dtype=jnp.float32)
    jparams = jpoet.convert_torch_state_dict(sd, jconfig)
    monkeypatch.setattr(jscorers, "resolve_zoo_checkpoint", lambda *a, **k: (jconfig, jparams))
    ctx = jscorers.ScoreContext(
        record=jload_reference(tmp_path / "ref.csv")["FAM_TEST"],
        dms_frame=pd.DataFrame({"mutant": mutants,
                                "mutated_sequence": [r["mutated_sequence"] for r in rows]}),
        msa_dir=tmp_path / "msa", weights_dir=tmp_path / "w_jax", batch_size=4,
        extra=dict(e.split("=") for e in EXTRA),
    )
    want = jscorers.score_poet(ctx)["PoET_score"].to_numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.load(tmp_path / "w_port" / "FAM_theta_0.2.npy"),
                                  np.load(tmp_path / "w_jax" / "FAM_theta_0.2.npy"))


def test_poet_without_an_msa_fails_its_task(tmp_path):
    _write_world(tmp_path)
    rc = tcli.main([
        "score", "--model", "poet", "--checkpoint", "poet_tiny", "--device", "cpu",
        "--dms-reference", str(tmp_path / "ref.csv"), "--dms-dir", str(tmp_path / "dms"),
        "--output-dir", str(tmp_path / "out"), "--quiet",
    ])
    assert rc == 1  # no --msa-dir: the task fails, isolated, and is recorded
    manifest = [json.loads(line) for line in (tmp_path / "out" / "manifest.jsonl").read_text().splitlines()]
    assert manifest[-1]["status"] == "failed" and "No MSA" in manifest[-1]["error"]
