"""The port's masked-marginal scoring (proteingym_tpu_torch.models.esm_scoring
and ops.gather_logprobs) against the JAX package on the same weights and
inputs, float32 on the CPU."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import esm_scoring as jsc
from proteingym_tpu.ops import gather_logprobs as jgl
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import esm_scoring as tsc
from proteingym_tpu_torch.ops import gather_logprobs as tgl
from tests.test_torch_esm2 import fair_esm_state

ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def models():
    sd = fair_esm_state(tesm.PRESETS["esm2_tiny"], seed=21)
    jcfg = jesm.PRESETS["esm2_tiny"]
    return (jesm.convert_torch_state_dict(sd, jcfg), jesm.make_apply_fn(jcfg),
            tesm.load_fair_esm_state_dict(sd, tesm.PRESETS["esm2_tiny"]))


def _seq(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list(AA), n))


@pytest.mark.parametrize("length,window,pad,chunk", [
    (30, 1024, 64, 8),     # short path, rows bucketed to 64
    (30, 1024, None, 7),   # short path, no bucketing, ragged chunk
    (70, 48, 64, 8),       # optimal-window path (72 tokens > window 48)
    (70, 47, None, 16),    # odd window: the reference's one-short quirk
])
def test_masked_marginal_table_matches_jax(models, length, window, pad, chunk):
    params, apply_fn, model = models
    tokens = tesm.ALPHABET.tokenize(_seq(length, length + window))
    want = np.asarray(jsc.masked_marginal_table(
        apply_fn, tokens, chunk=chunk, window=window, params=params,
        pad_to_multiple=pad))
    got = tsc.masked_marginal_table(model, tokens, chunk=chunk, window=window,
                                    pad_to_multiple=pad)
    assert got.shape == want.shape == (length + 2, len(tesm.ALPHABET))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_score_mutants_from_table_matches_jax():
    seq = _seq(20, 5)
    mutants = [f"{seq[0]}1A", f"{seq[3]}4C:{seq[9]}10W", "", "WT",
               f"{seq[19]}20Y:{seq[1]}2D:{seq[5]}6E", f"{seq[7]}8{seq[7]}"]
    table = np.random.default_rng(3).standard_normal((22, 33)).astype(np.float32)
    want = np.asarray(jsc.score_mutants_from_table(jnp.asarray(table), mutants, seq))
    got = tsc.score_mutants_from_table(torch.from_numpy(table), mutants, seq)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert got[2] == got[3] == 0.0 and got[5] == 0.0  # WT rows and a silent mutant


def test_wild_type_mismatch_raises():
    table = np.zeros((7, 33), np.float32)
    with pytest.raises(ValueError, match="wild-type mismatch"):
        tsc.score_mutants_from_table(table, ["C1A"], "MKTAY")


def test_score_assay_matches_jax(models):
    params, apply_fn, model = models
    seq = _seq(25, 9)
    mutants = [f"{seq[p]}{p + 1}{m}" for p in range(0, 25, 3) for m in "AWY" if m != seq[p]]
    mutants += [f"{seq[2]}3K:{seq[11]}12P", "WT"]
    want = jsc.score_assay(None, seq, mutants, chunk=8, params=params, apply_fn=apply_fn)
    got = tsc.score_assay(model, seq, mutants, chunk=8)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("strategy", ["wt-marginals", "pseudo-ppl"])
def test_unported_strategies_name_their_roadmap_item(models, strategy):
    """Both strategies are ported (ROADMAP.md queue 1, item 7): they score
    per assay, and only the packed path still refuses them, as the JAX
    package's does."""
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    scores = tsc.score_assay(models[2], "MKTAY", ["M1A", "K2W:Y5C"], strategy=strategy)
    assert scores.shape == (2,) and np.isfinite(scores).all()
    rec = tscorers.AssayRecord("X", "X.csv", "P", "MKTAY", 5)
    with pytest.raises(ValueError, match="masked-marginals only"):
        tscorers.score_esm_packed_batch([(rec, ["M1A"])], "esm2_tiny",
                                        extra={"scoring_strategy": strategy})


def test_row_log_softmax_gather_matches_jax():
    rng = np.random.default_rng(0)
    logits = (5 * rng.standard_normal((6, 11, 33))).astype(np.float32)
    offs = rng.integers(0, 11, 6).astype(np.int32)
    want = np.asarray(jgl.row_log_softmax_gather(jnp.asarray(logits), jnp.asarray(offs)))
    got = tgl.row_log_softmax_gather(torch.from_numpy(logits), torch.from_numpy(offs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_multi_log_softmax_gather_matches_jax():
    rng = np.random.default_rng(1)
    logits = (5 * rng.standard_normal((3, 11, 33))).astype(np.float32)
    offs = rng.integers(0, 11, (3, 4)).astype(np.int32)
    want = np.asarray(jgl.multi_log_softmax_gather(jnp.asarray(logits), jnp.asarray(offs)))
    got = tgl.multi_log_softmax_gather(torch.from_numpy(logits), torch.from_numpy(offs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
