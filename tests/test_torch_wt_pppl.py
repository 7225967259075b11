"""The port's WT-marginal and pseudo-perplexity scoring
(proteingym_tpu_torch.models.esm_scoring) against the JAX package on the
same weights and inputs, float32 on the CPU, down to the CLI's CSV."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import esm_scoring as jsc
from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import esm_scoring as tsc
from proteingym_tpu_torch.pipeline import cli as tcli
from tests.test_torch_cli import _read, _save_checkpoint, _write_assays
from tests.test_torch_esm2 import fair_esm_state

ATOL = 1e-4  # float32 log-probs through two layers on both sides
AA = "ACDEFGHIKLMNPQRSTVWY"


@pytest.fixture(scope="module")
def models():
    sd = fair_esm_state(tesm.PRESETS["esm2_tiny"], seed=41)
    jcfg = jesm.PRESETS["esm2_tiny"]
    return (jesm.convert_torch_state_dict(sd, jcfg), jesm.make_apply_fn(jcfg),
            tesm.load_fair_esm_state_dict(sd, tesm.PRESETS["esm2_tiny"], device="cpu"))


def _seq(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list(AA), n))


def _mutants(seq, seed, n=12):
    """Singles, a double and a triple, plus a WT row."""
    rng = np.random.default_rng(seed)
    pos = rng.choice(len(seq), n + 5, replace=False)
    out = [f"{seq[p]}{p + 1}{AA[(AA.index(seq[p]) + 1 + i) % 20]}"
           for i, p in enumerate(pos[:n])]
    out.append(":".join(f"{seq[p]}{p + 1}W" if seq[p] != "W" else f"W{p + 1}A"
                        for p in sorted(pos[n:n + 2])))
    out.append(":".join(f"{seq[p]}{p + 1}G" if seq[p] != "G" else f"G{p + 1}A"
                        for p in sorted(pos[n + 2:])))
    return out + ["WT"]


@pytest.mark.parametrize("length", [1100, 1500, 3000])
def test_window_plan_and_weights_equal_jax(length):
    got = tsc.overlapping_window_plan(length + 2, window=1024)
    assert got == jsc.overlapping_window_plan(length + 2, window=1024)
    if length == 3000:
        assert got == [0, 1978, 511, 1467, 989]
    w = tsc.esm_overlap_weights(1024)
    assert w.dtype == np.float64
    np.testing.assert_array_equal(w, jsc.esm_overlap_weights(1024))


def test_wt_marginal_table_matches_jax(models):
    params, apply_fn, model = models
    tokens = tesm.ALPHABET.tokenize(_seq(37, 1))  # T=39, one forward
    want = np.asarray(jsc.wt_marginal_table(apply_fn, tokens, params=params))
    got = tsc.wt_marginal_table(model, tokens)
    assert got.dtype == torch.float32 and got.shape == want.shape == (39, 33)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("length,window,n_windows", [
    (400, 300, 3),    # [0, 102, 51]: both ends plus the central window
    (250, 300, 1),    # total <= window: the single forward
    (3000, 1024, 5),  # the real window: [0, 1978, 511, 1467, 989]
])
def test_wt_marginal_table_overlapping_matches_jax(models, length, window, n_windows):
    params, apply_fn, model = models
    tokens = tesm.ALPHABET.tokenize(_seq(length, length))
    total = len(tokens)
    if total > window:
        assert len(tsc.overlapping_window_plan(total, window=window)) == n_windows
    want = np.asarray(jsc.wt_marginal_table_overlapping(
        None, tokens, window=window, params=params, apply_fn=apply_fn))
    calls = []
    real_forward = model.forward

    def counting_forward(tok, *a, **kw):
        calls.append(tuple(tok.shape))
        return real_forward(tok, *a, **kw)

    model.forward = counting_forward
    try:
        got = tsc.wt_marginal_table_overlapping(model, tokens, window=window)
    finally:
        del model.forward
    assert calls == [(n_windows, min(window, total))]  # all windows in one forward
    assert got.dtype == torch.float32 and got.shape == want.shape == (total, 33)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_pseudo_ppl_matches_jax(models):
    params, apply_fn, model = models
    seq = _seq(45, 3)
    want = jsc.pseudo_ppl(apply_fn, seq, chunk=8, params=params, pad_to_multiple=64)
    got = tsc.pseudo_ppl(model, seq, chunk=8, pad_to_multiple=64)
    assert isinstance(got, float)
    assert got == pytest.approx(want, abs=ATOL)


@pytest.mark.parametrize("strategy,length,window", [
    ("masked-marginals", 33, 1024),
    ("wt-marginals", 33, 1024),
    ("wt-marginals", 400, 300),  # overlapping windows
    ("pseudo-ppl", 21, 1024),
])
def test_score_assay_matches_jax(models, strategy, length, window):
    params, apply_fn, model = models
    seq = _seq(length, 7 + length)
    mutants = _mutants(seq, length)
    want = jsc.score_assay(None, seq, mutants, strategy=strategy, chunk=8, window=window,
                           params=params, apply_fn=apply_fn)
    got = tsc.score_assay(model, seq, mutants, strategy=strategy, chunk=8, window=window)
    assert got.shape == (len(mutants),)
    if strategy == "pseudo-ppl":
        assert got.dtype == np.float64
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert got[-1] == 0.0  # the WT row


def test_pseudo_ppl_keeps_an_offset_index(models):
    """Mutant positions count from ``offset_idx``, as apply_mutant takes them."""
    params, apply_fn, model = models
    seq = _seq(18, 5)
    mutants = [f"{seq[2]}13A" if seq[2] != "A" else "A13C"]
    want = jsc.score_assay(None, seq, mutants, strategy="pseudo-ppl", chunk=8,
                           offset_idx=11, params=params, apply_fn=apply_fn)
    got = tsc.score_assay(model, seq, mutants, strategy="pseudo-ppl", chunk=8, offset_idx=11)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    assert got[0] != 0.0


def test_unknown_strategy_raises(models):
    with pytest.raises(ValueError, match="Unknown strategy"):
        tsc.score_assay(models[2], "MKTAY", ["M1A"], strategy="entropy")


@pytest.mark.parametrize("strategy", ["wt-marginals", "pseudo-ppl"])
def test_port_cli_matches_jax_cli(tmp_path, strategy):
    ref, dms_dir, ids = _write_assays(tmp_path, n_assays=2)
    ckpt = _save_checkpoint(tmp_path / "a.pt", 51)
    common = ["--dms-reference", str(ref), "--dms-dir", str(dms_dir), "--batch-size", "8",
              "--quiet", "--checkpoint", f"esm2_tiny:{ckpt}",
              "--extra", f"scoring_strategy={strategy}"]
    assert jcli.main(["--platform", "cpu", "score", "--model", "esm",
                      "--output-dir", str(tmp_path / "jax")] + common) == 0
    assert tcli.main(["score", "--model", "esm", "--device", "cpu",
                      "--output-dir", str(tmp_path / "torch")] + common) == 0
    for dms_id in ids:
        want, got = _read(tmp_path / "jax" / f"{dms_id}.csv"), _read(tmp_path / "torch" / f"{dms_id}.csv")
        assert list(got[0]) == ["mutant", "DMS_score", "mutated_sequence", "esm2_tiny_score"]
        assert [r["mutant"] for r in got] == [r["mutant"] for r in want]
        np.testing.assert_allclose([float(r["esm2_tiny_score"]) for r in got],
                                   [float(r["esm2_tiny_score"]) for r in want],
                                   atol=ATOL, rtol=0)

