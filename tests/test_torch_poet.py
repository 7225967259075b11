"""The port's PoET (proteingym_tpu_torch.models.poet) against the JAX
package's: alphabet, context sampling and row building (identical), float32
logits through the state-dict bridge and from JAX's ``init_params`` (atol
1e-4), assay scores, and the model's causality and padding invariance.

On CPU tensors both attention tiers take the plain versions, so the logits
test holds the model around the kernels to the JAX ``apply``; the kernels
themselves are held to the same plain versions on the card.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import poet as jpoet
from proteingym_tpu_torch.models import poet as tpoet
from proteingym_tpu_torch.pipeline import checkpoints as tckpt

ATOL = 1e-4  # float32 on both sides; sums run in other orders
AA = "ACDEFGHIKLMNPQRSTVWY"
SHAPE = dict(num_layers=2, hidden_dim=32, num_heads=4, ffn_dim=64)
JAX_TINY = jpoet.PoetConfig(name="tiny", dtype=jnp.float32, **SHAPE)
TORCH_TINY = tpoet.PoetConfig(name="tiny", dtype=torch.float32, **SHAPE)


def poet_state(config, seed, fused=True, final_norm=True):
    """A PoET state dict with every weight random, ``linear2`` included
    (a random-init model zeroes it), as numpy float32."""
    rng = np.random.default_rng(seed)
    d, f, v = config.hidden_dim, config.ffn_dim, config.n_vocab

    def w(*shape):
        return (rng.standard_normal(shape) * 0.2).astype(np.float32)

    sd = {"token_embed.weight": w(v, d), "linear.weight": w(v, d), "linear.bias": w(v)}
    if final_norm:
        sd["norm.weight"], sd["norm.bias"] = 1 + w(d), w(d)
    for i in range(config.num_layers):
        p = f"decoder.layers.{i}"
        for n in ("norm1", "norm2", "norm3"):
            sd[f"{p}.{n}.weight"], sd[f"{p}.{n}.bias"] = 1 + w(d), w(d)
        for a in ("self_attn", "multihead_attn"):
            if fused:
                sd[f"{p}.{a}.in_proj_weight"], sd[f"{p}.{a}.in_proj_bias"] = w(3 * d, d), w(3 * d)
            else:
                for proj in ("q_proj", "k_proj", "v_proj"):
                    sd[f"{p}.{a}.{proj}.weight"], sd[f"{p}.{a}.{proj}.bias"] = w(d, d), w(d)
            sd[f"{p}.{a}.out_proj.weight"], sd[f"{p}.{a}.out_proj.bias"] = w(d, d), w(d)
        sd[f"{p}.linear1.weight"], sd[f"{p}.linear1.bias"] = w(f, d), w(f)
        sd[f"{p}.linear2.weight"], sd[f"{p}.linear2.bias"] = w(d, f), w(d)
    return sd


def _seqs(rng, lengths):
    return ["".join(rng.choice(list(AA), n)) for n in lengths]


def _logits_both(jparams, model, rows):
    tok, seg, pos, val = rows[:4]
    want = np.asarray(jpoet.apply(jparams, JAX_TINY, *(jnp.asarray(a) for a in (tok, seg, pos, val))))
    got = model(*(torch.from_numpy(a) for a in (tok, seg, pos, val))).numpy()
    return got, want, val


def test_alphabet_matches_jax():
    for seq in ("ARN-XOUBZ", "acdefghiklmnpqrstvwy", "MKT*$J."):
        np.testing.assert_array_equal(tpoet.ALPHABET.encode(seq), jpoet.ALPHABET.encode(seq))
    assert tpoet.ALPHABET.n_vocab == jpoet.ALPHABET.n_vocab == 24
    assert (tpoet.START, tpoet.STOP, tpoet.MASK_X) == (jpoet.START, jpoet.STOP, jpoet.MASK_X)


@pytest.mark.parametrize("weighted", [True, False])
def test_sample_context_matches_jax(weighted):
    rng = np.random.default_rng(3)
    fam = [s[:5] + "-" + s[5:] + "." for s in _seqs(rng, rng.integers(5, 30, 60))]
    w = 1.0 / rng.integers(1, 6, 60) if weighted else None
    for seed in (0, 1, 7):
        got = tpoet.sample_context(fam, w, max_tokens=200, seed=seed)
        assert got == jpoet.sample_context(fam, w, max_tokens=200, seed=seed)
        assert sum(len(s) + 2 for s in got) <= 200 and got


def test_build_rows_match_jax():
    rng = np.random.default_rng(4)
    ctx = _seqs(rng, (7, 12, 5, 9))
    queries = ["ACD-EFG", "ACDEFGHIKL", "MK"]
    for context in (ctx, []):
        got, want = tpoet.build_rows(context, queries), jpoet.build_rows(context, queries)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype


ROW_CASES = {  # name -> (context lengths, query lengths): >= 3 context segments
    "short": ((7, 9, 5, 11), (8, 10)),
    "long_row_routes_to_flash": ((60,) * 18, (8, 10)),  # T > 1024
}


@pytest.mark.parametrize("layout", ["fused_in_proj", "separate_qkv"])
@pytest.mark.parametrize("rows", sorted(ROW_CASES))
def test_logits_match_jax_through_state_dict(layout, rows):
    sd = poet_state(TORCH_TINY, seed=len(layout) + len(rows), fused=layout == "fused_in_proj")
    jparams = jpoet.convert_torch_state_dict(sd, JAX_TINY)
    model = tpoet.load_state_dict_poet(tpoet._empty_model(TORCH_TINY, "cpu"),
                                       {k: torch.from_numpy(v) for k, v in sd.items()})
    rng = np.random.default_rng(5)
    ctx_lens, q_lens = ROW_CASES[rows]
    built = tpoet.build_rows(_seqs(rng, ctx_lens), _seqs(rng, q_lens))
    assert (built[0].shape[1] > 1024) == (rows == "long_row_routes_to_flash")
    got, want, valid = _logits_both(jparams, model, built)
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


def test_missing_final_norm_is_dropped_as_in_jax():
    sd = poet_state(TORCH_TINY, seed=9, final_norm=False)
    jparams = jpoet.convert_torch_state_dict(sd, JAX_TINY)
    assert jparams["final_norm"] is None
    model = tpoet.load_state_dict_poet(tpoet._empty_model(TORCH_TINY, "cpu"), sd)
    assert model.norm is None
    rng = np.random.default_rng(6)
    got, want, valid = _logits_both(jparams, model, tpoet.build_rows(_seqs(rng, (6, 8, 7)), ["ACDEF"]))
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


def test_bridge_rejects_missing_and_misshapen_weights():
    sd = poet_state(TORCH_TINY, seed=2)
    del sd["decoder.layers.1.linear1.weight"]
    with pytest.raises(KeyError, match="linear1.weight"):
        tpoet.load_state_dict_poet(tpoet._empty_model(TORCH_TINY, "cpu"), sd)
    sd = poet_state(TORCH_TINY, seed=2)
    sd["linear.weight"] = sd["linear.weight"][:, :-1]
    with pytest.raises(ValueError, match="linear.weight"):
        tpoet.load_state_dict_poet(tpoet._empty_model(TORCH_TINY, "cpu"), sd)


def test_from_jax_params_reproduces_jax_logits():
    jparams = jpoet.init_params(jax.random.PRNGKey(0), JAX_TINY)
    model = tpoet.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams), TORCH_TINY)
    rng = np.random.default_rng(8)
    got, want, valid = _logits_both(jparams, model, tpoet.build_rows(_seqs(rng, (9, 6, 12)),
                                                                      ["ACDEFGH", "KLMN"]))
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL, rtol=0)


def test_score_assay_matches_jax():
    sd = poet_state(TORCH_TINY, seed=11)
    jparams = jpoet.convert_torch_state_dict(sd, JAX_TINY)
    model = tpoet.load_state_dict_poet(tpoet._empty_model(TORCH_TINY, "cpu"), sd)
    rng = np.random.default_rng(12)
    focus = "".join(rng.choice(list(AA), 15))
    msa = [focus] + ["".join(c if rng.random() > 0.3 else rng.choice(list(AA + "-")) for c in focus)
                     for _ in range(25)]
    weights = 1.0 / rng.integers(1, 4, len(msa))
    mutants = [focus[:p] + a + focus[p + 1:] for p, a in ((0, "W"), (4, "G"), (14, "K"))] + [focus]
    kw = dict(max_context_tokens=80, n_context_samples=3, seed=2, batch_size=2)
    got = tpoet.score_assay_poet(model, mutants, msa, weights, **kw)
    want = jpoet.score_assay_poet(jparams, JAX_TINY, mutants, msa, weights, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert len(set(np.round(got, 4))) > 1


def _tiny_model(seed=13):
    return tpoet.load_state_dict_poet(tpoet._empty_model(TORCH_TINY, "cpu"), poet_state(TORCH_TINY, seed))


def test_causality_over_flattened_row():
    model = _tiny_model()
    rng = np.random.default_rng(0)
    tok, seg, pos, val, _ = tpoet.build_rows(_seqs(rng, (6, 6)), ["ACDEFG"])
    changed = tok.copy()
    changed[0, -2] = (changed[0, -2] + 1) % 20  # a late query residue
    a, b = (model(*(torch.from_numpy(x) for x in (t, seg, pos, val))).numpy() for t in (tok, changed))
    np.testing.assert_allclose(a[0, :-2], b[0, :-2], atol=ATOL, rtol=0)
    assert not np.allclose(a[0, -2:], b[0, -2:], atol=ATOL)


def test_query_padding_invariance_and_batching():
    model = _tiny_model()
    rng = np.random.default_rng(2)
    ctx = _seqs(rng, (6, 9, 7))
    alone = tpoet.score_queries(model, ctx, ["ACDEFG"])
    padded = tpoet.score_queries(model, ctx, ["ACDEFG", "ACDEFGHIKLMN", "MK"], batch_size=2)
    np.testing.assert_allclose(alone[0], padded[0], atol=ATOL, rtol=0)
    empty = tpoet.score_queries(model, [], ["ACDEFG", "ACDEFG"])
    assert np.isfinite(empty).all() and empty[0] == pytest.approx(empty[1], abs=ATOL)


def test_init_random_is_seeded_and_zeroes_linear2():
    a = tpoet.init_random(TORCH_TINY, seed=1)
    b = tpoet.init_random(TORCH_TINY, seed=1)
    c = tpoet.init_random(TORCH_TINY, seed=2)
    assert torch.equal(a.token_embed.weight, b.token_embed.weight)
    assert not torch.equal(a.token_embed.weight, c.token_embed.weight)
    layer = a.decoder.layers[0]
    assert torch.count_nonzero(layer.linear2.weight) == 0
    assert float(layer.self_attn.q_proj.weight.std()) == pytest.approx(0.02, rel=0.3)
    assert torch.equal(layer.norm1.weight, torch.ones(TORCH_TINY.hidden_dim))


def test_presets_match_jax_shapes():
    for name, config in tpoet.POET_PRESETS.items():
        j = jpoet.POET_PRESETS[name]
        assert (config.num_layers, config.hidden_dim, config.num_heads, config.ffn_dim,
                config.n_vocab, config.final_norm) == (
            j.num_layers, j.hidden_dim, j.num_heads, j.ffn_dim, j.n_vocab, j.final_norm)
    assert tpoet.POET_PRESETS["poet_200m"].dtype == torch.bfloat16
    assert tpoet.POET_PRESETS["poet_200m"].head_dim == 64


def test_checkpoint_specs(tmp_path):
    tiny = tpoet.POET_PRESETS["poet_tiny"]
    sd = {k: torch.from_numpy(v) for k, v in poet_state(tiny, seed=21).items()}
    torch.save(sd, tmp_path / "bare.pt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                "hyper_parameters": {}}, tmp_path / "lightning.ckpt")
    m1, c1 = tckpt.load_poet_checkpoint(f"poet_tiny:{tmp_path / 'bare.pt'}")
    m2, c2 = tckpt.load_poet_checkpoint(f"poet_tiny:{tmp_path / 'lightning.ckpt'}")
    assert c1 == c2 == tiny
    for name, p in m1.state_dict().items():
        assert torch.equal(p, m2.state_dict()[name])
    assert torch.equal(m1.decoder.layers[1].linear2.weight, sd["decoder.layers.1.linear2.weight"])
    r1, c = tckpt.load_poet_checkpoint(None)  # the JAX scorer's default preset
    r2, _ = tckpt.load_poet_checkpoint("poet_tiny")
    assert c == tiny and torch.equal(r1.token_embed.weight, r2.token_embed.weight)
    orbax = tmp_path / "converted"
    orbax.mkdir()
    with pytest.raises(ValueError, match="JAX-only"):
        tckpt.load_poet_checkpoint(str(orbax))
    with pytest.raises(ValueError, match="unrecognised PoET checkpoint"):
        tckpt.load_poet_checkpoint("poet_huge:/x.pt")
