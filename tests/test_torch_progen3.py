"""The port's ProGen3 (proteingym_tpu_torch.models.progen3) against the JAX
package's, on the JAX tests' tiny float32 config: the router, the routed
MoE against the JAX dense ``moe_ffn`` (plain and gated experts), logits
through the reference state-dict layout (flat and fused) with and without
grouped-query heads, ``config_from_hf_json``, the mirrored
``score_sequences`` and the scorer's column.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import progen3 as jp3
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu_torch.models import progen3 as tp3
from proteingym_tpu_torch.pipeline import scorers as tscorers
from tests.test_progen3 import TINY
from tests.test_torch_ar_zoo import SCORE_ATOL, _assay, _check_columns, _contexts
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides; only summation orders differ (the routed experts
# add their outputs in expert order, the JAX route sums all of them)
ATOL = 1e-4
CPU = torch.device("cpu")
GQA = dataclasses.replace(TINY, num_kv_heads=2)


def port_config(c):
    fields = {f.name: getattr(c, f.name) for f in dataclasses.fields(tp3.ProGen3Config)
              if f.name != "dtype"}
    return tp3.ProGen3Config(**fields, dtype=torch.float32)


def reference_state(c, seed=0, fused=False):
    """A random reference ProGen3 state dict (torch Linear (out, in)), in
    the flat layout or the fused ``norm_attn_norm`` one."""
    rng = np.random.default_rng(seed)
    d, hd, f = c.hidden_dim, c.head_dim, c.ffn_dim
    w = lambda *shape, scale=0.2: (rng.standard_normal(shape) * scale).astype(np.float32)
    sd = {"model.embed_tokens.weight": w(c.vocab_size, d, scale=0.5),
          "model.embed_seq_id.weight": w(c.max_num_seqs, d, scale=0.1),
          "model.norm.weight": 1 + w(d, scale=0.1),
          "lm_head.weight": w(c.vocab_size, d, scale=d ** -0.5)}
    for i in range(c.num_layers):
        lp = f"model.layers.{i}"
        attn = f"{lp}.norm_attn_norm.self_attn" if fused else f"{lp}.self_attn"
        norm = f"{lp}.norm_attn_norm" if fused else lp
        sd[f"{norm}.input_layernorm.weight"] = 1 + w(d, scale=0.1)
        sd[f"{norm}.post_attention_layernorm.weight"] = 1 + w(d, scale=0.1)
        for name, n_out in (("q", c.num_heads * hd), ("k", c.kv_heads * hd),
                            ("v", c.kv_heads * hd)):
            sd[f"{attn}.{name}_proj.weight"] = w(n_out, d, scale=d ** -0.5)
        sd[f"{attn}.o_proj.weight"] = w(d, c.num_heads * hd, scale=d ** -0.5)
        moe = f"{lp}.block_sparse_moe"
        sd[f"{moe}.gate.weight"] = w(c.num_experts, d, scale=1.0)
        for e in range(c.num_experts):
            sd[f"{moe}.experts.{e}.w1.weight"] = w(f, d, scale=d ** -0.5)
            sd[f"{moe}.experts.{e}.w2.weight"] = w(d, f, scale=f ** -0.5)
            if c.gated_mlp:
                sd[f"{moe}.experts.{e}.w3.weight"] = w(f, d, scale=d ** -0.5)
    return sd


def _both(c, seed=0, fused=False):
    sd = reference_state(c, seed, fused)
    return (jp3.convert_torch_state_dict(sd, c),
            tp3.convert_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                         port_config(c), device=CPU))


def test_router_weights_match_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(3, 5, 32).astype(np.float32)
    router = rs.randn(32, 8).astype(np.float32)
    want = np.asarray(jp3.router_weights(jnp.asarray(x), jnp.asarray(router), 8, 2))
    got = tp3.router_weights(torch.from_numpy(x), torch.from_numpy(router), 8, 2).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert ((got > 0).sum(-1) == 2).all()


@pytest.mark.parametrize("gated", [False, True], ids=["plain", "gated"])
def test_routed_moe_matches_jax_dense_route(gated):
    c = dataclasses.replace(TINY, gated_mlp=gated)
    params, model = _both(c, seed=1)
    x = np.random.RandomState(2).randn(2, 6, c.hidden_dim).astype(np.float32)
    want = np.asarray(jp3.moe_ffn(jnp.asarray(x), params["layers"][0], c))
    got = tp3.moe_ffn(torch.from_numpy(x), model.model.layers[0].block_sparse_moe).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("config", [TINY, GQA], ids=["mha", "gqa"])
@pytest.mark.parametrize("fused", [False, True], ids=["flat", "fused"])
def test_logits_match_jax(config, fused):
    params, model = _both(config, seed=3, fused=fused)
    toks = np.random.RandomState(4).randint(0, 34, (2, 11))
    want = np.asarray(jp3.apply(params, config, jnp.asarray(toks, jnp.int32)))
    got = model(torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 11, 34)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    restricted = model.restricted_logits(torch.from_numpy(toks % 26)).numpy()
    np.testing.assert_allclose(
        restricted, np.asarray(jp3.restricted_logits_fn(params, config)(
            jnp.asarray(toks % 26, jnp.int32))), atol=ATOL, rtol=0)


def test_params_from_jax_and_missing_router():
    params = jp3.init_params(jax.random.PRNGKey(0), TINY)
    host = jax.tree_util.tree_map(np.asarray, params)
    model = tp3.convert_torch_state_dict(tp3.params_from_jax(host, TINY), port_config(TINY),
                                         device=CPU)
    toks = np.random.RandomState(5).randint(0, 34, (1, 9))
    np.testing.assert_allclose(model(torch.from_numpy(toks)).numpy(),
                               np.asarray(jp3.apply(params, TINY, jnp.asarray(toks, jnp.int32))),
                               atol=ATOL, rtol=0)
    sd = {k: v for k, v in reference_state(TINY).items() if ".gate." not in k}
    tmodel = tp3.convert_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                          port_config(TINY), device=CPU)
    jparams = jp3.convert_torch_state_dict(sd, TINY)
    np.testing.assert_allclose(tmodel(torch.from_numpy(toks)).numpy(),
                               np.asarray(jp3.apply(jparams, TINY, jnp.asarray(toks, jnp.int32))),
                               atol=ATOL, rtol=0)


def test_causal():
    _, model = _both(TINY, seed=6)
    toks = torch.from_numpy(np.random.RandomState(7).randint(0, 30, (1, 10)))
    toks2 = toks.clone()
    toks2[0, -1] = (toks2[0, -1] + 1) % 30
    # the routed experts' gathered batches differ between the two calls
    # (the last token's route), so products may round differently: 1e-5
    torch.testing.assert_close(model(toks)[0, :-1], model(toks2)[0, :-1], atol=1e-5, rtol=0)
    assert not torch.allclose(model(toks)[0, -1], model(toks2)[0, -1])


@pytest.mark.parametrize("inter", [160, None])
def test_config_from_hf_json_matches_jax(tmp_path, inter):
    meta = {"hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 8,
            "num_key_value_heads": 2, "intermediate_size": inter, "num_experts": 4,
            "num_experts_per_tok": 2, "gated_mlp": True, "rope_theta": 100000.0,
            "rms_norm_eps": 1e-5, "max_num_sequences": 16, "vocab_size": 34}
    f = tmp_path / "config.json"
    f.write_text(json.dumps(meta))
    want = jp3.config_from_hf_json(f, name="progen3-custom")
    got = tp3.config_from_hf_json(f, name="progen3-custom")
    assert {k: v for k, v in dataclasses.asdict(got).items() if k != "dtype"} == {
        k: v for k, v in dataclasses.asdict(want).items() if k != "dtype"}
    assert got.kv_heads == 2 and got.ffn_dim == (inter or 3 * 64)


def test_score_sequences_match_jax():
    params, model = _both(GQA, seed=8)
    seqs = ["MKTAYIAK", "ACDEFGHIKLMN", "WY"]
    want = jp3.score_sequences(params, GQA, seqs, batch_size=2)
    got = tp3.score_sequences(model, seqs, batch_size=2)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


def test_tokenizer_matches_jax():
    for seq, rev in (("MKTAYIAK", False), ("MKTAYIAK", True), ("AX*Z", False)):
        np.testing.assert_array_equal(tp3.TOKENIZER.encode_clm(seq, rev),
                                      jp3.TOKENIZER.encode_clm(seq, rev))


def test_scorer_column_matches_jax(monkeypatch):
    c = GQA
    params, model = _both(c, seed=9)
    monkeypatch.setitem(jp3.PRESETS, "tiny", c)
    monkeypatch.setitem(tp3.PRESETS, "tiny", model.config)
    muts, seqs = _assay()
    jctx, tctx = _contexts(muts, seqs, "tiny", {"params": params},
                           {"params": model.state_dict()})
    _check_columns(jscorers.score_progen3(jctx), tscorers.SCORERS["progen3"](tctx), "tiny_score")


def test_tiny_preset_runs_on_the_cpu():
    muts, seqs = _assay()
    _, tctx = _contexts(muts, seqs, None, {}, {"tiny": 1})
    out = tscorers.SCORERS["progen3"](tctx)
    assert np.isfinite(out["progen3-112m_score"]).all()
