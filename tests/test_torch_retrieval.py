"""The port's retrieval and TranceptEVE scoring (models/retrieval.py,
models/trancepteve.py) against the JAX package's: the Hamming filter, the
MSA prior (float64), the alpha and beta tables, the recalibration, the
fusion in both reading directions with EVE rows of -inf and an all-zero
MSA row, the priors of an assay, the recalibration target, the fused
score tables, and the ``tranception`` / ``trancepteve`` scorers through
both CLIs on one tiny HF-format Tranception directory and one EVE file
that the test writes (float32 on both sides: the HF dtype is switched from
bf16 on both).
"""

import csv
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import eve as jeve
from proteingym_tpu.models import retrieval as jret
from proteingym_tpu.models import tranception as jt
from proteingym_tpu.models import trancepteve as jte
from proteingym_tpu.pipeline import checkpoints as jckpt
from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.models import eve as teve
from proteingym_tpu_torch.models import retrieval as tret
from proteingym_tpu_torch.models import tranception as tt
from proteingym_tpu_torch.models import trancepteve as tte
from proteingym_tpu_torch.pipeline import checkpoints as tckpt
from proteingym_tpu_torch.pipeline import cli as tcli

from test_torch_eve import _both as eve_pair
from test_torch_tranception import JAX_TINY, TINY, hf_state

# the priors are float64 on both sides: only summation orders differ
PRIOR_ATOL = 1e-12
# fused float32 log-probs: the same float32 operations in another order
FUSE_ATOL = 1e-6
# score tables: summed log-likelihoods of ~50 tokens through a float32 model
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"


def _family(rs, n, length, lower=False, max_sub=0.95, focus=None):
    focus = focus or "".join(AA[i] for i in rs.randint(0, 20, length))
    rows = [focus]
    for i in range(n - 1):
        sub = rs.rand() * max_sub  # at 0.95 some rows fall under the 0.2 similarity filter
        row = "".join((AA[rs.randint(20)] if rs.rand() < sub else c) if rs.rand() > 0.1
                      else "-" for c in focus)
        rows.append(row.lower() if lower and i % 5 == 1 else row)
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hamming_filter_equals_jax(seed):
    rows = _family(np.random.RandomState(seed), 60, 33, lower=True)
    rows[3] = "X" * 33
    rows[4] = "-" * 33
    got = tret.hamming_filter(rows)
    assert got == jret.hamming_filter(rows)
    assert 4 < len(got) < 59  # the filter drops some rows and keeps others
    assert tret.hamming_filter(["--", "AC"]) == jret.hamming_filter(["--", "AC"]) == []


@pytest.mark.parametrize("filter_msa", [True, False])
@pytest.mark.parametrize("weighted", [True, False])
def test_log_msa_prior_equals_jax_in_float64(filter_msa, weighted):
    rs = np.random.RandomState(3)
    rows = _family(rs, 80, 21, lower=True)
    rows[7] = rows[7][:5] + "XBZ" + rows[7][8:]
    weights = rs.rand(80) if weighted else None
    args = (rows, weights, 4, 25, 30)
    got = tret.log_msa_prior(*args, filter_msa=filter_msa)
    want = jret.log_msa_prior(*args, filter_msa=filter_msa)
    assert got.dtype == np.float64 and got.shape == (30, 25)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    live = np.isfinite(want)
    assert live[4:25].all() and not live[:4].any() and not live[25:].any()
    np.testing.assert_allclose(got[live], want[live], atol=PRIOR_ATOL, rtol=0)
    with pytest.raises(ValueError, match="does not match"):
        tret.msa_prior(rows, weights, 4, 24, 30, filter_msa=filter_msa)


def test_alpha_and_beta_tables_equal_jax():
    # the substitution tables (the indel arms: tests/test_torch_indel.py)
    for depth in (0, 5, 9, 10, 11, 99, 100, 500, 999, 1000, 50_000, 99_999, 10**5, 10**6):
        for kind in ("TranceptEVE", "Tranception"):
            assert tret.msa_alpha(depth, False, kind) == jret.msa_alpha(depth, False, kind)
            assert tret.eve_beta(depth, False, kind) == jret.eve_beta(depth, False, kind)
            assert tret.msa_alpha(depth, retrieval_type=kind) == jret.msa_alpha(depth, False, kind)


@pytest.mark.parametrize("target", [-3.2, -3.6, -4.5])  # a mean below -log(20)
def test_recalibration_equals_jax(target):
    rs = np.random.RandomState(4)
    table = np.log(rs.dirichlet(np.ones(20) * 0.5, size=30))
    got = tret.recalibrate_log_prior(table, target)
    np.testing.assert_allclose(got, jret.recalibrate_log_prior(table, target),
                               atol=PRIOR_ATOL, rtol=0)
    assert abs(got.mean() - target) <= 0.001
    np.testing.assert_allclose(tret._logsumexp_rows(table), jret._logsumexp_rows(table),
                               atol=PRIOR_ATOL, rtol=0)


@pytest.mark.parametrize("reverse", [False, True], ids=["L_to_R", "R_to_L"])
@pytest.mark.parametrize("with_eve", [False, True], ids=["msa", "msa+eve"])
def test_fusion_equals_jax(reverse, with_eve):
    # rows of 12 shift positions whose windows start at 0, 5, 10 and 28 of a
    # 40-residue target; the MSA spans [8, 30) with one all-zero row (an
    # AR-only position); EVE covers every other column, -inf elsewhere
    rs = np.random.RandomState(5)
    b, t, v, full = 4, 12, 25, 40
    logits = rs.randn(b, t, v).astype(np.float32)
    shift = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    msa_lp = np.zeros((full, v), np.float32)
    msa_lp[8:30] = np.log(rs.dirichlet(np.ones(v), size=22))
    msa_lp[17] = 0.0
    starts = np.array([0, 5, 10, 28])
    ends = starts + (t - 2)
    targets = rs.randint(5, v, (b, t))
    targets[:, t - 2], targets[:, t - 1], targets[1, 3] = 2, 3, 1
    eve_lp = None
    if with_eve:
        eve_lp = np.full((full, v), -np.inf, np.float32)
        eve_lp[8:30:2, 5:] = np.log(rs.dirichlet(np.ones(v - 5), size=11))
    kw = dict(eve_prior=eve_lp, beta=0.6)
    fuse = tret.make_fusion(msa_lp, 8, 30, 0.3, device="cpu", **kw)
    got = fuse(torch.from_numpy(shift), torch.from_numpy(targets), torch.from_numpy(starts),
               torch.from_numpy(ends), reverse).numpy()
    jfuse = jret.make_fusion(msa_lp, 8, 30, 0.3, **kw)
    want = np.asarray(jfuse(jnp.asarray(shift), jnp.asarray(targets), jnp.asarray(starts),
                            jnp.asarray(ends), reverse))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FUSE_ATOL, rtol=0)
    assert not np.allclose(got, shift)


def _assay(rs, length, covered):
    target = "".join(AA[i] for i in rs.randint(0, 20, length))
    mutants, seqs = [], []
    for p in sorted(rs.choice(length, 10, replace=False)):
        to = AA[(AA.index(target[p]) + 1 + rs.randint(19)) % 20]
        mutants.append(f"{target[p]}{p + 1}{to}")
        seqs.append(target[:p] + to + target[p + 1:])
    msa = _family(rs, 40, covered, max_sub=0.6, focus=target[3:3 + covered])
    return target, mutants, seqs, msa


@pytest.mark.parametrize("kind,recalibrate", [("Tranception", False), ("TranceptEVE", False),
                                              ("TranceptEVE", True)])
def test_priors_and_fused_scores_equal_jax(kind, recalibrate):
    rs = np.random.RandomState(6)
    target, mutants, seqs, msa = _assay(rs, 48, 30)
    weights = rs.rand(len(msa))
    hf = hf_state(TINY, 6)
    model = tt.load_hf_state_dict(hf, TINY, device="cpu")
    jparams = jt.convert_torch_state_dict(hf, JAX_TINY)
    logits_fn = lambda tok: jt.apply(jparams, JAX_TINY, tok)
    eve_model, eve_params, eve_cfg = eve_pair(6, logvar=-60.0, seq_len=30)
    focus_cols = np.arange(30)
    kw = dict(eve_focus_cols=focus_cols, eve_focus_seq=msa[0], eve_num_samples=512)
    rcfg = dict(retrieval_type=kind, msa_start=3, msa_end=33, recalibrate=recalibrate)
    got = tte.build_priors(msa, weights, target, tte.RetrievalConfig(**rcfg),
                           eve_models=[eve_model], model=model, **kw)
    want = jte.build_priors(msa, weights, target, jte.RetrievalConfig(**rcfg),
                            eve_params_list=[eve_params], eve_config=eve_cfg,
                            logits_fn=logits_fn, **kw)
    assert got[2:] == want[2:]  # alpha, beta
    # 10 <= the filtered depth < 100
    assert got[2:] == ((0.6, 0.0) if kind == "Tranception" else (0.1, 0.3))
    # the MSA prior is float64 (recalibrated: to a float32 model's target);
    # the EVE prior is a float32 average of float32 decoder outputs
    for mine, theirs, atol, rtol in (
            (got[0], want[0], PRIOR_ATOL if not recalibrate else 1e-5, 0),
            (got[1], want[1], 1e-5, 1e-5)):
        if theirs is None:
            assert mine is None and kind == "Tranception"
            continue
        np.testing.assert_array_equal(np.isneginf(mine), np.isneginf(theirs))
        live = np.isfinite(theirs)
        np.testing.assert_allclose(mine[live], theirs[live], atol=atol, rtol=rtol)

    table = tte.score_trancepteve(model, mutants, seqs, target, rcfg=tte.RetrievalConfig(**rcfg),
                                  msa_log_prior=got[0], eve_log_prior=got[1], alpha=got[2],
                                  beta=got[3], batch_size=4)
    frame = jte.score_trancepteve(jparams, JAX_TINY, mutants, seqs, target,
                                  rcfg=jte.RetrievalConfig(**rcfg), msa_log_prior=want[0],
                                  eve_log_prior=want[1], alpha=want[2], beta=want[3],
                                  batch_size=4)
    assert table.names == list(frame.columns)
    assert table["mutated_sequence"].tolist() == frame["mutated_sequence"].tolist()
    for name in table.names[1:]:
        np.testing.assert_allclose(table[name], frame[name].to_numpy(), atol=SCORE_ATOL, rtol=0)


def test_recalibration_target_equals_jax():
    hf = hf_state(TINY, 7)
    model = tt.load_hf_state_dict(hf, TINY, device="cpu")
    jparams = jt.convert_torch_state_dict(hf, JAX_TINY)
    target = "".join(AA[i] for i in np.random.RandomState(7).randint(0, 20, 37))
    got = tte.transformer_wt_mean_logprob(model, target, 4, 30)
    want = jte.transformer_wt_mean_logprob(lambda tok: jt.apply(jparams, JAX_TINY, tok),
                                           target, 4, 30)
    assert got == pytest.approx(want, abs=1e-5)


# ---------------------------------------------------------------------------
# Both CLIs on one assay, one HF directory and one EVE file
# ---------------------------------------------------------------------------

@pytest.fixture
def float32_hf(monkeypatch):
    """HF checkpoints run in float32 on both sides (bf16 is the default of
    both): the port's HF_DTYPE, and the JAX loader's config."""
    monkeypatch.setattr(tckpt, "HF_DTYPE", torch.float32)
    load = jckpt.load_tranception_checkpoint

    def load_f32(spec):
        params, config = load(spec)
        return params, dataclasses.replace(config, dtype=jnp.float32)

    monkeypatch.setattr(jckpt, "load_tranception_checkpoint", load_f32)


def _cli_world(tmp_path):
    rs = np.random.RandomState(8)
    target, mutants, seqs, msa = _assay(rs, 44, 30)
    mutants.append(f"{target[0]}1{target[0]}")
    seqs.append(target)  # a WT row through its own mutant string
    hf = tmp_path / "hf"
    hf.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in hf_state(TINY, 8).items()},
               hf / "pytorch_model.bin")
    (hf / "config.json").write_text(json.dumps(
        {"model_type": "tranception", "n_layer": 2, "n_embd": 64, "n_head": 4, "n_ctx": 64}))
    eve_model, _, _ = eve_pair(8, logvar=-60.0, seq_len=30)
    torch.save(teve.checkpoint_dict(eve_model), tmp_path / "eve.pt")
    (tmp_path / "msa").mkdir()
    with open(tmp_path / "msa" / "FAM.a2m", "w") as f:
        for i, row in enumerate(msa):
            f.write(f">FAM/4-33\n{row}\n" if i == 0 else f">h{i}/1-30\n{row}\n")
    with open(tmp_path / "ref.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
        w.writerow(["FAM_T", "FAM_T.csv", "P1", target, 44, "FAM.a2m", 4, 33, 0.2, "FAM.npy"])
    (tmp_path / "dms").mkdir()
    with open(tmp_path / "dms" / "FAM_T.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mutant", "mutated_sequence", "DMS_score"])
        w.writerows([m, s, i] for i, (m, s) in enumerate(zip(mutants, seqs)))
    return target, seqs


@pytest.mark.parametrize("model,extra", [
    ("tranception", ["retrieval_type=Tranception"]),
    ("trancepteve", ["retrieval_type=TranceptEVE", "eve_checkpoints=EVE", "eve_num_samples=600"]),
    ("tranception", []),
], ids=["tranception_retrieval", "trancepteve", "no_retrieval"])
def test_cli_writes_the_jax_cli_file(tmp_path, float32_hf, model, extra):
    target, seqs = _cli_world(tmp_path)
    extra = [e.replace("EVE", str(tmp_path / "eve.pt")) if e.startswith("eve_ch") else e
             for e in extra]
    common = ["--model", model, "--checkpoint", str(tmp_path / "hf"), "--msa-dir",
              str(tmp_path / "msa"), "--weights-dir", str(tmp_path / "w"), "--dms-reference",
              str(tmp_path / "ref.csv"), "--dms-dir", str(tmp_path / "dms"), "--batch-size",
              "4", "--quiet"] + (["--extra", *extra] if extra else [])
    assert tcli.main(["score", "--device", "cpu", "--output-dir", str(tmp_path / "port")]
                     + common) == 0
    assert jcli.main(["--platform", "cpu", "score", "--output-dir", str(tmp_path / "jax")]
                     + common) == 0
    files = {}
    for side in ("port", "jax"):
        with open(tmp_path / side / "FAM_T.csv", newline="") as f:
            files[side] = list(csv.reader(f))
    port, want = files["port"], files["jax"]
    assert port[0] == want[0] == ["mutated_sequence", "avg_score_L_to_R", "avg_score_R_to_L",
                                  "avg_score"]
    assert [r[0] for r in port] == [r[0] for r in want]
    assert port[-1] == [target, "0.0", "0.0", "0.0"] == want[-1]
    np.testing.assert_allclose(np.asarray([r[1:] for r in port[1:]], dtype=np.float64),
                               np.asarray([r[1:] for r in want[1:]], dtype=np.float64),
                               atol=SCORE_ATOL, rtol=0)
    manifest = (tmp_path / "port" / "manifest.jsonl").read_text()
    assert '"rows": 11' in manifest  # 10 mutants and the WT: the table's rows
