"""The port's ESM-C (proteingym_tpu_torch.models.esmc) against the JAX
package's, on the tiny preset in float32: the tokenizer, logits of a
padded batch through one SDK-layout state dict (with the single head and
with the RegressionHead; the JAX side reads the same dict through its
converter), the JAX init pytree through ``params_from_jax``, and masked-
and WT-marginal scores, a sequence longer than the window included.

The JAX side runs inside ``jax.enable_x64(False)`` (the test harness turns
x64 on), its production float32. On CPU tensors the attention takes the
plain version.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esmc as je
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu.pipeline import scorers_extra as jextra
from proteingym_tpu_torch.models import esmc as te
from proteingym_tpu_torch.pipeline import scorers as tscorers
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides; only summation orders differ: ~1e-6 relative on
# logits of magnitude ~1-10
ATOL = 1e-4
# sums of a few log-prob differences
SCORE_ATOL = 1e-4
CPU = torch.device("cpu")
AA = "ACDEFGHIKLMNPQRSTVWY"
F32 = lambda: jax.enable_x64(False)  # noqa: E731
JC = dataclasses.replace(je.PRESETS["esmc_tiny"], dtype=jnp.float32)
TC = dataclasses.replace(te.PRESETS["esmc_tiny"], dtype=torch.float32)


def sdk_state(c, seed=0, regression_head=False):
    """A random ESM-C state dict in the SDK's layout (torch Linear (out, in)
    weights): biased attention and ffn layer norms, bias-free q/k and final
    norms, a bias-free fused qkv, out and ffn."""
    rng = np.random.default_rng(seed)
    d, h, v = c.embed_dim, c.ffn_hidden, c.alphabet_size
    w = lambda *shape, scale=0.2: (rng.standard_normal(shape) * scale).astype(np.float32)
    sd = {"embed.weight": w(v, d, scale=1.0), "transformer.norm.weight": 1 + w(d, scale=0.1)}
    for i in range(c.num_layers):
        p = f"transformer.blocks.{i}"
        for ln in ("attn.layernorm_qkv.0", "ffn.0"):
            sd[f"{p}.{ln}.weight"] = 1 + w(d, scale=0.1)
            sd[f"{p}.{ln}.bias"] = w(d, scale=0.1)
        sd[f"{p}.attn.q_ln.weight"] = 1 + w(d, scale=0.1)
        sd[f"{p}.attn.k_ln.weight"] = 1 + w(d, scale=0.1)
        sd[f"{p}.attn.layernorm_qkv.1.weight"] = w(3 * d, d, scale=d ** -0.5)
        sd[f"{p}.attn.out_proj.weight"] = w(d, d, scale=d ** -0.5)
        sd[f"{p}.ffn.1.weight"] = w(2 * h, d, scale=d ** -0.5)
        sd[f"{p}.ffn.3.weight"] = w(d, h, scale=h ** -0.5)
    if regression_head:
        sd["sequence_head.0.weight"] = w(d, d, scale=d ** -0.5)
        sd["sequence_head.0.bias"] = w(d, scale=0.1)
        sd["sequence_head.2.weight"] = 1 + w(d, scale=0.1)
        sd["sequence_head.2.bias"] = w(d, scale=0.1)
        sd["sequence_head.3.weight"] = w(v, d, scale=d ** -0.5)
        sd["sequence_head.3.bias"] = w(v, scale=0.1)
    else:
        sd["lm_head.weight"] = w(v, d, scale=d ** -0.5)
    return sd


def both(seed=0, regression_head=False, jc=JC, tc=TC):
    sd = sdk_state(jc, seed, regression_head)
    with F32():
        params = je.convert_torch_state_dict(sd, jc)
    return params, te.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, tc,
                                      device=CPU)


@pytest.mark.parametrize("seq", ["MKTAYIAKQR", "ACDEFGHIKLMNPQRSTVWY", "XBUZO.-|", "M"])
def test_tokenizer_matches_jax(seq):
    np.testing.assert_array_equal(te.ALPHABET.tokenize(seq), je.ALPHABET.tokenize(seq))
    np.testing.assert_array_equal(te.ALPHABET.tokenize(seq, pad_to=24),
                                  je.ALPHABET.tokenize(seq, pad_to=24))
    assert (te.ALPHABET.mask_idx, te.ALPHABET.padding_idx) == (32, 1) == (
        je.ALPHABET.mask_idx, je.ALPHABET.padding_idx)
    assert len(te.ALPHABET) == len(je.ALPHABET) == 33


@pytest.mark.parametrize("regression_head", [False, True], ids=["lm_head", "regression_head"])
def test_padded_batch_logits_match_jax(regression_head):
    params, model = both(seed=1, regression_head=regression_head)
    assert hasattr(model, "sequence_head") == regression_head
    toks = np.stack([je.ALPHABET.tokenize("MKTAYIAKQR", pad_to=17),
                     je.ALPHABET.tokenize("ACDEFGHIKLMNPQR")])
    with F32():
        want = np.asarray(je.apply(params, JC, jnp.asarray(toks)))
    got = model(torch.from_numpy(toks).long()).numpy()
    assert got.shape == (2, 17, 33) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_params_from_jax_gives_the_same_model():
    with F32():
        params = je.init_params(jax.random.PRNGKey(0), JC)
        host = jax.tree_util.tree_map(np.asarray, params)
        toks = je.ALPHABET.tokenize("MKTAYIAKQRQISF")[None]
        want = np.asarray(je.apply(params, JC, jnp.asarray(toks)))
    model = te.load_state_dict(te.params_from_jax(host, TC), TC, device=CPU)
    np.testing.assert_allclose(model(torch.from_numpy(toks).long()).numpy(), want,
                               atol=ATOL, rtol=0)


def test_bf16_preset_keeps_the_jax_dtypes():
    # bf16 weights for the trunk's products and the embedding, float32 layer
    # norms and head; float32 logits
    model = te.init_random(te.PRESETS["esmc_tiny"], seed=0, device=CPU)
    dtypes = {name: p.dtype for name, p in model.named_parameters()}
    assert dtypes["embed.weight"] == torch.bfloat16
    assert dtypes["transformer.blocks.0.attn.layernorm_qkv.1.weight"] == torch.bfloat16
    assert dtypes["transformer.blocks.0.attn.q_ln.weight"] == torch.float32
    assert dtypes["lm_head.weight"] == torch.float32
    out = model(torch.from_numpy(te.ALPHABET.tokenize("MKTAYIAK")[None]).long())
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def _mutants(seq, stride, rng):
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, len(seq), stride) for a in "AGW"
            if a != seq[p]]
    return muts + [f"{seq[0]}1K:{seq[5]}6P", "WT", f"{seq[3]}4{seq[3]}"]


@pytest.mark.parametrize("strategy,length,window", [
    ("masked-marginals", 30, 1024),
    ("wt-marginals", 30, 1024),
    ("masked-marginals", 100, 64),   # optimal windows of 64 tokens
    ("wt-marginals", 1100, 1024),    # overlapping windows, stitched
], ids=["masked", "wt", "masked_windowed", "wt_overlapping"])
def test_score_assay_matches_jax(strategy, length, window):
    rng = np.random.default_rng(length)
    seq = "".join(rng.choice(list(AA), length))
    muts = _mutants(seq, 3 if length < 200 else 97, rng)
    params, model = both(seed=2, regression_head=True)
    with F32():
        want = je.score_assay(params, JC, seq, muts, strategy=strategy, chunk=8, window=window)
    got = te.score_assay(model, seq, muts, strategy=strategy, chunk=8, window=window)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    assert got[muts.index("WT")] == 0.0 and np.isfinite(got).all()


def scorer_contexts(seq, muts, checkpoint, jax_extra, port_extra, structure_dir=None):
    """The JAX and port ScoreContexts of one assay (record fields the
    scorers read: target_seq, UniProt_ID, DMS_id)."""
    import pandas as pd

    rec = types.SimpleNamespace(target_seq=seq, UniProt_ID="P0", DMS_id="SYN")
    jctx = jscorers.ScoreContext(record=rec, dms_frame=pd.DataFrame(
        {"mutant": muts, "mutated_sequence": [""] * len(muts)}), checkpoint=checkpoint,
        structure_dir=structure_dir, batch_size=4, extra=jax_extra)
    tctx = tscorers.ScoreContext(record=rec, mutants=muts, device=CPU, checkpoint=checkpoint,
                                 structure_dir=structure_dir, batch_size=4, extra=port_extra)
    return jctx, tctx


@pytest.mark.parametrize("strategy", ["masked-marginals", "wt-marginals"])
def test_scorer_column_matches_jax(monkeypatch, strategy):
    rng = np.random.default_rng(9)
    seq = "".join(rng.choice(list(AA), 26))
    muts = _mutants(seq, 2, rng)
    sd = sdk_state(JC, seed=9, regression_head=True)
    with F32():
        params = je.convert_torch_state_dict(sd, JC)
    monkeypatch.setitem(je.PRESETS, "tiny32", JC)
    monkeypatch.setitem(te.PRESETS, "tiny32", TC)
    monkeypatch.setattr(je, "init_params", lambda rng, c: params)
    extra = {"scoring_strategy": strategy}
    jctx, tctx = scorer_contexts(seq, muts, "tiny32", extra,
                                 dict(extra, params={k: torch.from_numpy(v) for k, v in sd.items()}))
    with F32():
        want = jextra.score_esmc(jctx)["esmc_tiny_score"]
    got = tscorers.SCORERS["esmc"](tctx)
    assert list(got) == ["esmc_tiny_score"]
    np.testing.assert_allclose(got["esmc_tiny_score"], want.to_numpy(), atol=SCORE_ATOL, rtol=0)


def test_checkpoint_files_and_unknown_names(tmp_path):
    # an SDK state dict file: its preset found by layers and width; an
    # unknown name and an orbax directory raise
    from proteingym_tpu_torch.pipeline.checkpoints import resolve_preset_state

    tiny = te.PRESETS["esmc_tiny"]
    path = tmp_path / "esmc_tiny.pth"
    torch.save({k: torch.from_numpy(v) for k, v in sdk_state(tiny, seed=10).items()}, path)
    shape = lambda sd: tscorers._sdk_shape(sd)  # noqa: E731
    dims = lambda c: (c.num_layers, c.embed_dim)  # noqa: E731
    config, state = resolve_preset_state(str(path), te.PRESETS, "esmc_300m", "ESM-C", shape, dims)
    assert config is tiny and "embed.weight" in state
    assert resolve_preset_state(None, te.PRESETS, "esmc_300m", "ESM-C")[0].name == "esmc_300m"
    with pytest.raises(ValueError, match="Unknown ESM-C checkpoint"):
        resolve_preset_state("esmc_1b", te.PRESETS, "esmc_300m", "ESM-C", shape, dims)
    (tmp_path / "conv" / "params").mkdir(parents=True)
    with pytest.raises(ValueError, match="JAX-only"):
        resolve_preset_state(str(tmp_path / "conv"), te.PRESETS, "esmc_300m", "ESM-C", shape, dims)
    wide = dataclasses.replace(tiny, embed_dim=96)
    torch.save({k: torch.from_numpy(v) for k, v in sdk_state(wide).items()}, path)
    with pytest.raises(ValueError, match="matches no preset"):
        resolve_preset_state(str(path), te.PRESETS, "esmc_300m", "ESM-C", shape, dims)
