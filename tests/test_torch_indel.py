"""The port's indel track against the JAX package's: the realigned priors
(update_msa_prior_indel, make_indel_fusion: tables, spans and the EVE
rows of inserted positions), the indel arms of the alpha and beta tables,
the per-row fusion in both reading directions, the indel slice plans, the
TranceptEVE and Tranception score tables with ``indel_mode``, and
``score --indel-mode`` through both CLIs on one tiny HF-format
Tranception directory and one EVE file (float32 on both sides).
"""

import csv
import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import ar_scoring as jar
from proteingym_tpu.models import retrieval as jret
from proteingym_tpu.models import tranception as jt
from proteingym_tpu.models import trancepteve as jte
from proteingym_tpu.pipeline import checkpoints as jckpt
from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.models import ar_scoring as tar
from proteingym_tpu_torch.models import eve as teve
from proteingym_tpu_torch.models import retrieval as tret
from proteingym_tpu_torch.models import tranception as tt
from proteingym_tpu_torch.models import trancepteve as tte
from proteingym_tpu_torch.pipeline import checkpoints as tckpt
from proteingym_tpu_torch.pipeline import cli as tcli

from test_torch_eve import _both as eve_pair
from test_torch_retrieval import _family
from test_torch_tranception import JAX_TINY, TINY, hf_state

# fused float32 log-probs: the same float32 operations in another order
FUSE_ATOL = 1e-6
# score tables: summed log-likelihoods of ~50 tokens through a float32 model
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"


def _indels(rs, target, n):
    """``n`` distinct indel variants of ``target``: deletions and
    insertions of 1-3 residues, a substitution plus an indel, two indels;
    at the ends too."""
    out = []
    while len(out) < n:
        seq = target
        kinds = [rs.randint(4)]
        if kinds[0] == 3:
            kinds = [1, 2]
        for kind in kinds:
            at, size = rs.randint(0, len(seq) + 1), rs.randint(1, 4)
            if kind == 0:  # a substitution, then an indel
                p = rs.randint(len(seq))
                seq = seq[:p] + AA[(AA.index(seq[p]) + 1 + rs.randint(19)) % 20] + seq[p + 1:]
                kind = 1 + rs.randint(2)
            if kind == 1:
                seq = seq[:at] + seq[at + size:]
            else:
                seq = seq[:at] + "".join(AA[i] for i in rs.randint(0, 20, size)) + seq[at:]
        if seq != target and seq not in out:
            out.append(seq)
    return out


def _log_prior(rs, full, start, end, v=25):
    lp = np.full((full, v), -np.inf)
    lp[start:end] = np.log(rs.dirichlet(np.ones(v), size=end - start))
    return lp


def _eve_prior(rs, full, start, end, v=25):
    ev = np.full((full, v), -np.inf, dtype=np.float32)
    cols = np.arange(start, end)[rs.rand(end - start) < 0.8]  # some non-focus columns
    ev[cols, 5:] = np.log(rs.dirichlet(np.ones(v - 5), size=len(cols)))
    return ev


@pytest.mark.parametrize("start,end", [(0, 30), (6, 30), (6, 40)], ids=["at0", "inside", "to_end"])
@pytest.mark.parametrize("which", ["msa", "eve"])
def test_update_msa_prior_indel_equals_jax(start, end, which):
    rs = np.random.RandomState(start + end)
    target = "".join(AA[i] for i in rs.randint(0, 20, 40))
    prior = (_log_prior if which == "msa" else _eve_prior)(rs, 40, start, end)
    for seq in _indels(rs, target, 30) + [target, target.lower(), target[:start]]:
        got = tret.update_msa_prior_indel(prior, start, end, target[start:end], seq)
        want = jret.update_msa_prior_indel(prior, start, end, target[start:end], seq)
        assert got[1:] == want[1:]
        assert got[0].dtype == want[0].dtype == np.float64
        np.testing.assert_array_equal(got[0], want[0])


def test_alpha_and_beta_tables_equal_jax_in_indel_mode():
    for depth in (0, 5, 9, 10, 11, 99, 100, 10**5, 10**6):
        for kind in ("TranceptEVE", "Tranception"):
            for indel in (False, True):
                assert tret.msa_alpha(depth, indel, kind) == jret.msa_alpha(depth, indel, kind)
                assert tret.eve_beta(depth, indel, kind) == jret.eve_beta(depth, indel, kind)
    assert tret.msa_alpha(50, True) == 0.5 and tret.eve_beta(50, True) == 0.1


@pytest.mark.parametrize("start,end", [(0, 30), (6, 30)], ids=["at0", "inside"])
@pytest.mark.parametrize("with_eve", [False, True], ids=["msa", "msa+eve"])
def test_make_indel_fusion_equals_jax(start, end, with_eve):
    rs = np.random.RandomState(11)
    target = "".join(AA[i] for i in rs.randint(0, 20, 40))
    seqs = _indels(rs, target, 25)
    seqs.insert(4, seqs[2])  # a repeated sequence gets one table
    msa_lp = _log_prior(rs, 40, start, end)
    eve_lp = _eve_prior(rs, 40, start, end) if with_eve else None
    kw = dict(eve_prior=eve_lp, beta=0.1)
    got, got_of = tret.make_indel_fusion(msa_lp, start, end, 0.5, target, seqs, device="cpu",
                                         **kw)
    want, want_of = jret.make_indel_fusion(msa_lp, start, end, 0.5, target, seqs, **kw)
    assert got.per_row and got_of == want_of and len(got_of) == 26  # 25 unique + the WT
    np.testing.assert_array_equal(got.msa_lp.numpy(), np.asarray(want.args["msa_lp"]))
    assert got.msa_lp.shape[1] % 64 == 0
    np.testing.assert_array_equal(got.msa_start.numpy(), np.asarray(want.args["msa_start"]))
    np.testing.assert_array_equal(got.msa_end.numpy(), np.asarray(want.args["msa_end"]))
    assert float(got.alpha) == float(want.args["alpha"])
    if with_eve:
        np.testing.assert_array_equal(got.eve_lp.numpy(), np.asarray(want.args["eve_lp"]))
        assert float(got.beta) == float(want.args["beta"])
        # inserted rows (all-zero MSA rows) are -inf in the EVE table
        zero = ~(got.msa_lp != 0).any(-1)
        assert bool(zero.any()) and bool(torch.isneginf(got.eve_lp[zero]).all())
    else:
        assert got.eve_lp is None and "eve_lp" not in want.args


@pytest.mark.parametrize("reverse", [False, True], ids=["L_to_R", "R_to_L"])
@pytest.mark.parametrize("with_eve", [False, True], ids=["msa", "msa+eve"])
def test_per_row_fusion_equals_jax(reverse, with_eve):
    # 6 rows of 40 shift positions, each its own table (a deletion, an
    # insertion, the WT...), windows [0, len) as indel rows have them
    rs = np.random.RandomState(12)
    target = "".join(AA[i] for i in rs.randint(0, 20, 36))
    seqs = _indels(rs, target, 5) + [target]
    msa_lp = _log_prior(rs, 36, 4, 30)
    eve_lp = _eve_prior(rs, 36, 4, 30) if with_eve else None
    kw = dict(eve_prior=eve_lp, beta=0.1)
    fuse, table_of = tret.make_indel_fusion(msa_lp, 4, 30, 0.5, target, seqs, device="cpu", **kw)
    jfuse, _ = jret.make_indel_fusion(msa_lp, 4, 30, 0.5, target, seqs, **kw)
    b, t, v = len(seqs), 40, 25
    logits = rs.randn(b, t, v).astype(np.float32)
    shift = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    targets = rs.randint(5, v, (b, t))
    ends = np.asarray([len(s) for s in seqs])
    for r, n in enumerate(ends):  # special tokens past each row's end
        targets[r, n:] = 2
    targets[1, 3] = 1
    starts = np.zeros(b, dtype=np.int64)
    tids = np.asarray([table_of[s] for s in seqs])
    got = fuse(torch.from_numpy(shift), torch.from_numpy(targets), torch.from_numpy(starts),
               torch.from_numpy(ends), reverse, torch.from_numpy(tids)).numpy()
    want = np.asarray(jfuse(jnp.asarray(shift), jnp.asarray(targets), jnp.asarray(starts),
                            jnp.asarray(ends), reverse, jnp.asarray(tids)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=FUSE_ATOL, rtol=0)
    assert not np.allclose(got, shift)


def _plan_tuples(plans):
    return [(p.mutated_sequence, p.sliced_sequence, p.window_start, p.window_end)
            for p in plans]


def test_indel_sequence_slices_equal_jax():
    rs = np.random.RandomState(13)
    target = "".join(AA[i] for i in rs.randint(0, 20, 50))
    seqs = _indels(rs, target, 20)
    seqs[7:7] = [target, seqs[3]]  # the WT and a repeat among the variants
    got = tar.get_sequence_slices(seqs, seqs, target, 30, indel_mode=True)
    want = jar.get_sequence_slices(seqs, seqs, target, 30, indel_mode=True)
    assert _plan_tuples(got) == _plan_tuples(want)
    assert all(p.window_start == 0 and p.window_end == len(p.mutated_sequence) for p in got)


def _indel_assay(rs, length, covered, start=3):
    target = "".join(AA[i] for i in rs.randint(0, 20, length))
    seqs = _indels(rs, target, 12)
    msa = _family(rs, 40, covered, max_sub=0.6, focus=target[start:start + covered])
    return target, seqs, msa


@pytest.mark.parametrize("kind,mirror", [("TranceptEVE", True), ("Tranception", True),
                                         ("TranceptEVE", False)])
def test_indel_priors_and_scores_equal_jax(kind, mirror):
    rs = np.random.RandomState(14)
    target, seqs, msa = _indel_assay(rs, 44, 30)
    seqs.insert(5, target)  # the WT in the assay: a row of zeros at the end
    weights = rs.rand(len(msa))
    hf = hf_state(TINY, 14)
    model = tt.load_hf_state_dict(hf, TINY, device="cpu")
    jparams = jt.convert_torch_state_dict(hf, JAX_TINY)
    eve_model, eve_params, eve_cfg = eve_pair(14, logvar=-60.0, seq_len=30)
    kw = dict(eve_focus_cols=np.arange(30), eve_focus_seq=msa[0], eve_num_samples=512)
    rcfg = dict(retrieval_type=kind, msa_start=3, msa_end=33, indel_mode=True)
    got = tte.build_priors(msa, weights, target, tte.RetrievalConfig(**rcfg),
                           eve_models=[eve_model], **kw)
    want = jte.build_priors(msa, weights, target, jte.RetrievalConfig(**rcfg),
                            eve_params_list=[eve_params], eve_config=eve_cfg, **kw)
    assert got[2:] == want[2:] == ((0.6, 0.0) if kind == "Tranception" else (0.5, 0.1))
    table = tte.score_trancepteve(model, seqs, seqs, target, rcfg=tte.RetrievalConfig(**rcfg),
                                  msa_log_prior=got[0], eve_log_prior=got[1], alpha=got[2],
                                  beta=got[3], batch_size=4, scoring_mirror=mirror,
                                  indel_mode=True)
    frame = jte.score_trancepteve(jparams, JAX_TINY, seqs, seqs, target,
                                  rcfg=jte.RetrievalConfig(**rcfg), msa_log_prior=want[0],
                                  eve_log_prior=want[1], alpha=want[2], beta=want[3],
                                  batch_size=4, scoring_mirror=mirror, indel_mode=True)
    assert table.names == list(frame.columns)
    assert table["mutated_sequence"].tolist() == frame["mutated_sequence"].tolist()
    for name in table.names[1:]:
        np.testing.assert_allclose(table[name], frame[name].to_numpy(), atol=SCORE_ATOL, rtol=0)
    assert table["mutated_sequence"][-1] == target and table["avg_score"][-1] == 0.0
    # the priors moved the scores: the same model without them differs
    bare = tte.score_trancepteve(model, seqs, seqs, target, batch_size=4,
                                 scoring_mirror=mirror, indel_mode=True)
    assert not np.allclose(bare["avg_score"][:-1], table["avg_score"][:-1], atol=1e-3)


def test_score_mutants_ar_indel_without_priors_equals_jax():
    # rows of several lengths land in several buckets of 32 tokens
    hf = hf_state(TINY, 15)
    model = tt.load_hf_state_dict(hf, TINY, device="cpu")
    jparams = jt.convert_torch_state_dict(hf, JAX_TINY)
    rs = np.random.RandomState(15)
    target = "".join(AA[i] for i in rs.randint(0, 20, 30))
    seqs = _indels(rs, target, 8) + [target[:5], target + "ACDEFGHIKLMNP"]
    got = tar.score_mutants_ar(model, tt.VOCAB.tokenize, tt.VOCAB.PAD, seqs, seqs, target, 60,
                               batch_size=3, indel_mode=True, device="cpu")
    want = jar.score_mutants_ar(lambda tok: jt.apply(jparams, JAX_TINY, tok), jt.VOCAB.tokenize,
                                jt.VOCAB.PAD, seqs, seqs, target, 60, batch_size=3,
                                indel_mode=True)
    assert got.names == list(want.columns)
    assert got["mutated_sequence"].tolist() == want["mutated_sequence"].tolist()
    for name in got.names[1:]:
        np.testing.assert_allclose(got[name], want[name].to_numpy(), atol=SCORE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# Both CLIs on one indel assay, one HF directory and one EVE file
# ---------------------------------------------------------------------------

@pytest.fixture
def float32_hf(monkeypatch):
    """HF checkpoints run in float32 on both sides (bf16 is the default)."""
    monkeypatch.setattr(tckpt, "HF_DTYPE", torch.float32)
    load = jckpt.load_tranception_checkpoint

    def load_f32(spec):
        params, config = load(spec)
        return params, dataclasses.replace(config, dtype=jnp.float32)

    monkeypatch.setattr(jckpt, "load_tranception_checkpoint", load_f32)


def write_indel_world(tmp_path, seed=16, length=44, covered=30):
    """An indel assay (ProteinGym's layout: ``mutant`` holds the mutated
    sequence) with the WT among its rows, its alignment over residues
    4-33, a reference CSV, a tiny HF Tranception directory and an EVE
    file; returns (target, mutated sequences)."""
    rs = np.random.RandomState(seed)
    target, seqs, msa = _indel_assay(rs, length, covered)
    seqs.append(target)
    hf = tmp_path / "hf"
    hf.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in hf_state(TINY, seed).items()},
               hf / "pytorch_model.bin")
    (hf / "config.json").write_text(json.dumps(
        {"model_type": "tranception", "n_layer": 2, "n_embd": 64, "n_head": 4, "n_ctx": 64}))
    eve_model, _, _ = eve_pair(seed, logvar=-60.0, seq_len=covered)
    torch.save(teve.checkpoint_dict(eve_model), tmp_path / "eve.pt")
    (tmp_path / "msa").mkdir()
    with open(tmp_path / "msa" / "FAM.a2m", "w") as f:
        for i, row in enumerate(msa):
            f.write(f">FAM/4-33\n{row}\n" if i == 0 else f">h{i}/1-{covered}\n{row}\n")
    with open(tmp_path / "ref.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
        w.writerow(["FAM_I", "FAM_I.csv", "P1", target, length, "FAM.a2m", 4, 33, 0.2,
                    "FAM.npy"])
    (tmp_path / "dms").mkdir()
    with open(tmp_path / "dms" / "FAM_I.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mutant", "mutated_sequence", "DMS_score", "DMS_score_bin"])
        w.writerows([s, s, i, i % 2] for i, s in enumerate(seqs))
    return target, seqs


def run_both_clis(tmp_path, model, extra=(), checkpoint=None, indel=True):
    """``score`` through the port's CLI (cpu) and the JAX CLI; returns the
    two CSVs' rows."""
    common = ["--model", model, "--msa-dir", str(tmp_path / "msa"), "--weights-dir",
              str(tmp_path / "w"), "--dms-reference", str(tmp_path / "ref.csv"), "--dms-dir",
              str(tmp_path / "dms"), "--batch-size", "4", "--quiet"]
    common += (["--indel-mode"] if indel else []) + (
        ["--checkpoint", checkpoint] if checkpoint else []) + (
        ["--extra", *extra] if extra else [])
    assert tcli.main(["score", "--device", "cpu", "--output-dir", str(tmp_path / "port")]
                     + common) == 0
    assert jcli.main(["--platform", "cpu", "score", "--output-dir", str(tmp_path / "jax")]
                     + common) == 0
    out = {}
    for side in ("port", "jax"):
        (name,) = [p.name for p in (tmp_path / side).glob("*.csv")]
        with open(tmp_path / side / name, newline="") as f:
            out[side] = list(csv.reader(f))
    return out["port"], out["jax"]


@pytest.mark.parametrize("model,extra", [
    ("trancepteve", ["retrieval_type=TranceptEVE", "eve_checkpoints=EVE", "eve_num_samples=600"]),
    ("tranception", ["retrieval_type=Tranception"]),
], ids=["trancepteve", "tranception_retrieval"])
def test_cli_indel_mode_writes_the_jax_cli_file(tmp_path, float32_hf, model, extra):
    target, seqs = write_indel_world(tmp_path)
    extra = [e.replace("EVE", str(tmp_path / "eve.pt")) if e.startswith("eve_ch") else e
             for e in extra]
    port, want = run_both_clis(tmp_path, model, extra, checkpoint=str(tmp_path / "hf"))
    assert port[0] == want[0] == ["mutated_sequence", "avg_score_L_to_R", "avg_score_R_to_L",
                                  "avg_score"]
    assert [r[0] for r in port] == [r[0] for r in want]
    assert [r[0] for r in port[1:]] == seqs  # one row per variant, the WT last
    assert port[-1] == [target, "0.0", "0.0", "0.0"] == want[-1]
    np.testing.assert_allclose(np.asarray([r[1:] for r in port[1:]], dtype=np.float64),
                               np.asarray([r[1:] for r in want[1:]], dtype=np.float64),
                               atol=SCORE_ATOL, rtol=0)
