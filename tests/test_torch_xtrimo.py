"""The port's xTrimoPGLM (proteingym_tpu_torch.models.xtrimo) against the
JAX package's, on the tiny preset in float32: ``apply`` in both modes (the
AR head without the RegressionHead's first layers), the reference recipes
on their edge cases (an invalid mutant, a multi-mutant, sequences longer
than ``window_size - 2`` for the MLM window quirk and the CLM chunks),
``score_assay`` in both modes, and the batched rows against the JAX
function's row at a time.

The JAX side runs inside ``jax.enable_x64(False)``; CPU tensors take the
plain attention.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import xtrimo as jx
from proteingym_tpu_torch.models import xtrimo as tx
from tests.test_torch_esmc import ATOL, F32, both
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides: sums of a few log-prob differences (MLM), or
# differences of per-token mean CE over ~30 tokens (AR)
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
JC = dataclasses.replace(jx.PRESETS["xtrimopglm_tiny"], dtype=jnp.float32)
TC = dataclasses.replace(tx.PRESETS["xtrimopglm_tiny"], dtype=torch.float32)


def models(seed=0, regression_head=False):
    return both(seed, regression_head, jc=JC, tc=TC)


@pytest.mark.parametrize("mode", ["mlm", "ar"])
@pytest.mark.parametrize("regression_head", [False, True], ids=["lm_head", "regression_head"])
def test_apply_matches_jax(mode, regression_head):
    params, model = models(seed=1, regression_head=regression_head)
    toks = np.stack([jx.ALPHABET.tokenize("MKTAYIAKQR", pad_to=15),
                     jx.ALPHABET.tokenize("ACDEFGHIKLMNP")])
    with F32():
        want = np.asarray(jx.apply(params, JC, jnp.asarray(toks), mode=mode))
    with torch.no_grad():
        got = tx.apply(model, torch.from_numpy(toks).long(), mode).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_ar_mode_is_causal():
    _, model = models(seed=2)
    toks = torch.from_numpy(jx.ALPHABET.tokenize("MKTAYIAKQR")[None]).long()
    toks2 = toks.clone()
    toks2[0, -2] = 5
    with torch.no_grad():
        a, b = tx.apply(model, toks, "ar"), tx.apply(model, toks2, "ar")
    torch.testing.assert_close(a[0, :-2], b[0, :-2], atol=0, rtol=0)
    assert not torch.allclose(a[0, -2:], b[0, -2:])


@pytest.mark.parametrize("seq_len", [10, 14, 15, 30, 61])
def test_recipes_match_jax(seq_len):
    # window 16: sequences past 14 residues take the centred windows (MLM)
    # and 14-residue chunks (CLM)
    rng = np.random.default_rng(seq_len)
    seq = "".join(rng.choice(list(AA), seq_len))
    for pos in range(seq_len):
        assert tx.mlm_window_for_position(seq_len, pos, 16) == jx.mlm_window_for_position(
            seq_len, pos, 16)
    muts = [f"{seq[0]}1A", f"{seq[1]}2W:{seq[4]}5G", "Z3A", f"{seq[2]}{seq_len + 1}A", "WT",
            f"{seq[-1]}{seq_len}C", "", f"{seq[3]}4{seq[3]}"]
    assert tx.parse_mutations(seq, muts) == jx.parse_mutations(seq, muts)
    stub_mlm = lambda w, rel: np.linspace(-3, -1, 20) + 0.01 * len(w) + 0.1 * rel  # noqa: E731
    stub_clm = lambda chunk: (float(sum(map(ord, chunk)) % 97), len(chunk) + 1)  # noqa: E731
    assert tx.score_mutations_mlm_recipe(seq, muts, stub_mlm, 16) == \
        jx.score_mutations_mlm_recipe(seq, muts, stub_mlm, 16)
    assert tx.score_mutations_clm_recipe(seq, muts, stub_clm, 16) == \
        jx.score_mutations_clm_recipe(seq, muts, stub_clm, 16)


def _assay(seq_len, seed):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), seq_len))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, seq_len, 4) for a in "AW" if a != seq[p]]
    muts += [f"{seq[1]}2K:{seq[6]}7P", "WT", f"{seq[0]}1{seq[0]}", "Q999A", f"B{3}A"]
    return seq, muts


@pytest.mark.parametrize("mode", ["mlm", "ar"])
@pytest.mark.parametrize("seq_len,window", [(24, 1024), (40, 16)], ids=["short", "windowed"])
def test_score_assay_matches_jax(mode, seq_len, window):
    seq, muts = _assay(seq_len, seq_len)
    params, model = models(seed=3, regression_head=mode == "mlm")
    with F32():
        want = jx.score_assay(params, JC, seq, muts, [""] * len(muts), mode=mode,
                              window_size=window)
    got = tx.score_assay(model, seq, muts, mode=mode, batch_size=5, window_size=window)
    # invalid mutants (WT, an unknown wild type, out of range) are NaN on both sides
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[muts.index("WT")]) and np.isnan(got[-1]) and np.isnan(got[-2])
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


@pytest.mark.parametrize("mode", ["mlm", "ar"])
def test_batched_rows_equal_row_at_a_time(mode):
    # chunks of 14 over 40 residues: CLM rows of 16 and 14 tokens batch apart
    seq, muts = _assay(40, 5)
    _, model = models(seed=4)
    one = tx.score_assay(model, seq, muts, mode=mode, batch_size=1, window_size=16)
    many = tx.score_assay(model, seq, muts, mode=mode, batch_size=7, window_size=16)
    np.testing.assert_allclose(many, one, atol=1e-5, rtol=0, equal_nan=True)


@pytest.mark.parametrize("mode", ["mlm", "ar"])
def test_scorer_column_matches_jax(monkeypatch, mode):
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_esmc import scorer_contexts, sdk_state

    seq, muts = _assay(30, 6)
    sd = sdk_state(JC, seed=7)
    with F32():
        params = jx.esmc.convert_torch_state_dict(sd, JC)
    monkeypatch.setitem(jx.PRESETS, "tiny32", JC)
    monkeypatch.setitem(tx.PRESETS, "tiny32", TC)
    monkeypatch.setattr(jx, "init_params", lambda rng, c: params)
    jctx, tctx = scorer_contexts(seq, muts, "tiny32", {"mode": mode},
                                 {"mode": mode, "params": {k: torch.from_numpy(v)
                                                           for k, v in sd.items()}})
    with F32():
        want = jextra.score_xtrimo(jctx)["xtrimopglm_score"].to_numpy()
    got = tscorers.SCORERS["xtrimopglm"](tctx)["xtrimopglm_score"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


def test_checkpoint_path_and_unknown_preset_raise(tmp_path):
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_esmc import scorer_contexts

    path = tmp_path / "x.pt"
    torch.save({}, path)
    for spec in ("xtrimopglm_100b", str(path)):
        _, tctx = scorer_contexts("MKTAYIAK", ["M1A"], spec, {}, {})
        with pytest.raises(ValueError, match="Unknown xTrimoPGLM"):
            tscorers.SCORERS["xtrimopglm"](tctx)
