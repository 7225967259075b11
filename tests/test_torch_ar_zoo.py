"""The port's AR zoo (proteingym_tpu_torch.models.ar_zoo: ProGen2, RITA,
ProtGPT2) against the JAX package's, on the JAX tests' tiny float32
configs: logits through published-layout state dicts (each JAX side loads
the same random file through its own converter), the restricted logits,
the tokenizers, causality, ``score_mutants_ar(target_seq=None)`` frames
and the three scorers' columns.

On CPU tensors the attention takes the plain version (the tiny heads are 8
wide; the card's float32 kernel is held to the same plain version there).
"""

import dataclasses
import functools

import numpy as np
import pandas as pd
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import ar_scoring as jar
from proteingym_tpu.models import ar_zoo as jz
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu_torch.models import ar_scoring as tar
from proteingym_tpu_torch.models import ar_zoo as tz
from proteingym_tpu_torch.pipeline import checkpoints as tckpt
from proteingym_tpu_torch.pipeline import scorers as tscorers
from tests.test_ar_zoo import TINY_GPT2, TINY_PROGEN, TINY_RITA
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides; only summation orders differ: ~1e-6 relative on
# logits of magnitude up to ~10
ATOL = 1e-4
# mean log-likelihoods per residue (sums of ~15-20 log-probs over the length)
SCORE_ATOL = 1e-5
AA = "ACDEFGHIKLMNPQRSTVWY"
CPU = torch.device("cpu")


def port_config(jax_config, port_cls):
    """The port's config with a JAX config's fields, in float32."""
    fields = {f.name: getattr(jax_config, f.name) for f in dataclasses.fields(port_cls)
              if f.name != "dtype"}
    return port_cls(**fields, dtype=torch.float32)


def _w(rng, *shape, scale=0.2):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ln(sd, rng, name, d):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = 1 + _w(rng, d, scale=0.1), _w(rng, d, scale=0.1)


def progen2_state(c, seed=0):
    """A random published ProGen2 state dict (torch Linear (out, in)), plus
    the reference's attention buffers, which both loaders ignore."""
    rng = np.random.default_rng(seed)
    d = c.embed_dim
    sd = {"transformer.wte.weight": _w(rng, c.vocab_size, d, scale=0.5),
          "lm_head.weight": _w(rng, c.vocab_size, d, scale=d ** -0.5),
          "lm_head.bias": _w(rng, c.vocab_size, scale=0.1)}
    _ln(sd, rng, "transformer.ln_f", d)
    for i in range(c.num_layers):
        p = f"transformer.h.{i}"
        _ln(sd, rng, f"{p}.ln_1", d)
        sd[f"{p}.attn.qkv_proj.weight"] = _w(rng, 3 * d, d, scale=d ** -0.5)
        sd[f"{p}.attn.out_proj.weight"] = _w(rng, d, d, scale=d ** -0.5)
        sd[f"{p}.mlp.fc_in.weight"] = _w(rng, 4 * d, d, scale=d ** -0.5)
        sd[f"{p}.mlp.fc_in.bias"] = _w(rng, 4 * d, scale=0.05)
        sd[f"{p}.mlp.fc_out.weight"] = _w(rng, d, 4 * d, scale=(4 * d) ** -0.5)
        sd[f"{p}.mlp.fc_out.bias"] = _w(rng, d, scale=0.05)
        sd[f"{p}.attn.causal_mask"] = np.tril(np.ones((8, 8), np.float32))
    return sd


def rita_state(c, seed=0, lm_bias=True):
    rng = np.random.default_rng(seed)
    d, f = c.embed_dim, c.ffn_dim
    sd = {"transformer.embedding.weight": _w(rng, c.vocab_size, d, scale=0.5),
          "lm_head.weight": _w(rng, c.vocab_size, d, scale=d ** -0.5)}
    if lm_bias:
        sd["lm_head.bias"] = _w(rng, c.vocab_size, scale=0.1)
    _ln(sd, rng, "transformer.final_norm", d)
    for i in range(c.num_layers):
        p = f"transformer.layers.{i}"
        _ln(sd, rng, f"{p}.attn_norm", d)
        _ln(sd, rng, f"{p}.mlp_norm", d)
        for name, (n_in, n_out) in (("self_attention.query", (d, d)),
                                    ("self_attention.key", (d, d)),
                                    ("self_attention.value", (d, d)),
                                    ("self_attention.proj", (d, d)),
                                    ("mlp.0", (d, f)), ("mlp.2", (f, d))):
            sd[f"{p}.{name}.weight"] = _w(rng, n_out, n_in, scale=n_in ** -0.5)
            sd[f"{p}.{name}.bias"] = _w(rng, n_out, scale=0.05)
    return sd


def gpt2_state(c, seed=0):
    """A random HF GPT-2 state dict: Conv1D weights (in, out), the tied
    lm_head and the attention buffers, which both loaders ignore."""
    rng = np.random.default_rng(seed)
    d = c.embed_dim
    sd = {"transformer.wte.weight": _w(rng, c.vocab_size, d, scale=0.5),
          "transformer.wpe.weight": _w(rng, c.n_ctx, d, scale=0.1)}
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    _ln(sd, rng, "transformer.ln_f", d)
    for i in range(c.num_layers):
        p = f"transformer.h.{i}"
        _ln(sd, rng, f"{p}.ln_1", d)
        _ln(sd, rng, f"{p}.ln_2", d)
        for name, (n_in, n_out) in (("attn.c_attn", (d, 3 * d)), ("attn.c_proj", (d, d)),
                                    ("mlp.c_fc", (d, 4 * d)), ("mlp.c_proj", (4 * d, d))):
            sd[f"{p}.{name}.weight"] = _w(rng, n_in, n_out, scale=n_in ** -0.5)
            sd[f"{p}.{name}.bias"] = _w(rng, n_out, scale=0.05)
        sd[f"{p}.attn.bias"] = np.tril(np.ones((1, 1, 8, 8), np.float32))
    return sd


def to_torch(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


# a ProGen2 width with two heads in each of the mp_num = 8 shards' q, v and
# k parts (the tiny config has one), so a wrong split order or head layout
# inside a shard shows too
WIDE_PROGEN = dataclasses.replace(TINY_PROGEN, embed_dim=64, num_heads=16, rotary_dim=2)
FAMILIES = {
    "progen2": (TINY_PROGEN, tz.ProGen2Config, progen2_state, jz.progen2_convert_torch_state_dict,
                jz.progen2_apply, tz.progen2_load_state_dict, 30),
    "progen2_two_heads_a_shard": (WIDE_PROGEN, tz.ProGen2Config, progen2_state,
                                  jz.progen2_convert_torch_state_dict, jz.progen2_apply,
                                  tz.progen2_load_state_dict, 30),
    "rita": (TINY_RITA, tz.RitaConfig, rita_state, jz.rita_convert_torch_state_dict,
             jz.rita_apply, tz.rita_load_state_dict, 26),
    "gpt2": (TINY_GPT2, tz.Gpt2Config, gpt2_state, jz.gpt2_convert_torch_state_dict,
             jz.gpt2_apply, tz.gpt2_load_state_dict, 64),
}


def _models(family, seed=0):
    jc, port_cls, state, convert, apply, load, vocab = FAMILIES[family]
    sd = state(jc, seed)
    tc = port_config(jc, port_cls)
    return (jc, convert(sd, jc), apply), load(to_torch(sd), tc, device=CPU), vocab


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_logits_match_jax_through_published_state_dicts(family):
    (jc, params, apply), model, vocab = _models(family)
    toks = np.random.default_rng(1).integers(0, vocab, (3, 13))
    want = np.asarray(apply(params, jc, jnp.asarray(toks, jnp.int32)))
    got = model(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (3, 13, jc.vocab_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_from_jax_gives_the_same_model(family):
    (jc, params, _), model, vocab = _models(family, seed=3)
    bridge = {"progen2": tz.progen2_params_from_jax, "rita": tz.rita_params_from_jax,
              "gpt2": tz.gpt2_params_from_jax}[family.split("_")[0]]
    host = jax.tree_util.tree_map(np.asarray, params)
    again = FAMILIES[family][5](bridge(host, model.config), model.config, device=CPU)
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, vocab, (2, 9)))
    torch.testing.assert_close(again(toks), model(toks), atol=0, rtol=0)


def test_progen2_split_order_shows():
    # the q, v, k order of each shard matters at these widths: swapping the
    # v and k blocks of every shard changes the logits by far more than ATOL
    c = WIDE_PROGEN
    sd = progen2_state(c)
    local = c.embed_dim // c.mp_num
    swapped = dict(sd)
    for i in range(c.num_layers):
        key = f"transformer.h.{i}.attn.qkv_proj.weight"
        w = sd[key].reshape(c.mp_num, 3, local, c.embed_dim)
        swapped[key] = w[:, [0, 2, 1]].reshape(3 * c.embed_dim, c.embed_dim)
    tc = port_config(c, tz.ProGen2Config)
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, 30, (2, 11)))
    a = tz.progen2_load_state_dict(to_torch(sd), tc, device=CPU)(toks)
    b = tz.progen2_load_state_dict(to_torch(swapped), tc, device=CPU)(toks)
    assert float((a - b).abs().max()) > 100 * ATOL


def test_restricted_logits_match_jax():
    (jc, params, _), model, _ = _models("progen2")
    toks = np.random.default_rng(5).integers(0, 25, (2, 10))
    want = np.asarray(jz.progen2_restricted_logits_fn(params, jc)(jnp.asarray(toks, jnp.int32)))
    got = model.restricted_logits(torch.from_numpy(toks)).numpy()
    assert got.shape == (2, 10, 25)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_rita_lm_head_without_bias_is_zero_as_in_jax():
    c = port_config(TINY_RITA, tz.RitaConfig)
    sd = rita_state(TINY_RITA, lm_bias=False)
    model = tz.rita_load_state_dict(to_torch(sd), c, device=CPU)
    params = jz.rita_convert_torch_state_dict(sd, TINY_RITA)
    assert float(model.lm_head.bias.abs().max()) == 0.0
    np.testing.assert_array_equal(np.asarray(params["lm_head"]["b"]), 0.0)


@pytest.mark.parametrize("seq", ["1ACDEXZB2", "MKT*UO-ak", ""])
def test_tokenizers_match_jax(seq):
    np.testing.assert_array_equal(tz.ProGen2Tokenizer().encode(seq), jz.ProGen2Tokenizer().encode(seq))
    np.testing.assert_array_equal(tz.RitaTokenizer().encode(seq), jz.RitaTokenizer().encode(seq))


@pytest.mark.parametrize("family", ["progen2", "rita", "gpt2"])
def test_causal(family):
    _, model, vocab = _models(family)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, vocab, (1, 12)))
    toks2 = toks.clone()
    toks2[0, -1] = (toks2[0, -1] + 1) % vocab
    a, b = model(toks), model(toks2)
    torch.testing.assert_close(a[0, :-1], b[0, :-1], atol=0, rtol=0)
    assert not torch.allclose(a[0, -1], b[0, -1])


def _assay(n=7, length=15, seed=7):
    rng = np.random.default_rng(seed)
    wt = "".join(rng.choice(list(AA), length))
    muts, seqs = [], []
    for p in rng.choice(length, n, replace=False):
        to = AA[(AA.index(wt[p]) + 3) % 20]
        muts.append(f"{wt[p]}{p + 1}{to}")
        seqs.append(wt[:p] + to + wt[p + 1:])
    # a repeated row and the WT: the left join gives each its sequence's scores
    return muts + [muts[0], f"{wt[0]}1{wt[0]}"], seqs + [seqs[0], wt]


@pytest.mark.parametrize("context", [64, 10])  # one window, and sliding windows of 10
def test_absolute_ar_frames_match_jax(context):
    (jc, params, _), model, _ = _models("progen2")
    muts, seqs = _assay()
    aa = {c: i for i, c in enumerate("ABCDEFGHIKLMNOPQRSTUVWXYZ")}
    tok = lambda s: np.asarray([aa[c] for c in s], np.int64)
    want = jar.score_mutants_ar(jz.progen2_restricted_logits_fn(params, jc), tok,
                                pad_id=aa["X"], mutants=muts, mutated_sequences=seqs,
                                target_seq=None, model_context_len=context, batch_size=3)
    got = tar.score_mutants_ar(model.restricted_logits, tok, pad_id=aa["X"], mutants=muts,
                               mutated_sequences=seqs, target_seq=None,
                               model_context_len=context, batch_size=3, device=CPU)
    assert got.names == list(want.columns)
    assert list(got["mutated_sequence"]) == list(want["mutated_sequence"])
    for col in ("avg_score_L_to_R", "avg_score_R_to_L", "avg_score"):
        np.testing.assert_allclose(got[col], want[col].to_numpy(), atol=SCORE_ATOL, rtol=0)


def _contexts(muts, seqs, checkpoint, jax_extra, port_extra):
    jctx = jscorers.ScoreContext(record=None, dms_frame=pd.DataFrame(
        {"mutant": muts, "mutated_sequence": seqs}), checkpoint=checkpoint, batch_size=4,
        extra=jax_extra)
    tctx = tscorers.ScoreContext(record=None, mutants=muts, device=CPU, mutated_sequences=seqs,
                                 checkpoint=checkpoint, batch_size=4, extra=port_extra)
    return jctx, tctx


def _check_columns(want, got, column):
    assert list(got) == ["avg_score_L_to_R", "avg_score_R_to_L", column]
    for col in got:
        np.testing.assert_allclose(got[col], want[col].to_numpy(), atol=SCORE_ATOL, rtol=0)
    assert np.isfinite(got[column]).all()


@pytest.mark.parametrize("family", ["progen2", "rita"])
def test_scorer_columns_match_jax(family, monkeypatch):
    (jc, params, _), model, _ = _models(family)
    muts, seqs = _assay()
    jpresets, tpresets = {"progen2": (jz.PROGEN2_PRESETS, tz.PROGEN2_PRESETS),
                          "rita": (jz.RITA_PRESETS, tz.RITA_PRESETS)}[family]
    monkeypatch.setitem(jpresets, "tiny", jc)
    monkeypatch.setitem(tpresets, "tiny", model.config)
    jctx, tctx = _contexts(muts, seqs, "tiny", {"params": params},
                           {"params": model.state_dict()})
    want = getattr(jscorers, f"score_{family}")(jctx)
    got = tscorers.SCORERS[family](tctx)
    _check_columns(want, got, "tiny_score")


def test_protgpt2_scorer_column_matches_jax(monkeypatch):
    # the scorers build their GPT-2 config from --extra widths with the
    # 50,257-token vocabulary; both sides run it in float32 here
    jc = jz.Gpt2Config(num_layers=2, embed_dim=32, num_heads=4, dtype=jnp.float32)
    sd = gpt2_state(jc, seed=8)
    monkeypatch.setattr(jz, "Gpt2Config", functools.partial(jz.Gpt2Config, dtype=jnp.float32))
    monkeypatch.setattr(tz, "Gpt2Config", functools.partial(tz.Gpt2Config, dtype=torch.float32))
    muts, seqs = _assay()
    widths = {"num_layers": 2, "embed_dim": 32, "num_heads": 4}
    jctx, tctx = _contexts(muts, seqs, None,
                           dict(widths, params=jz.gpt2_convert_torch_state_dict(sd, jc)),
                           dict(widths, params=to_torch(sd)))
    _check_columns(jscorers.score_protgpt2(jctx), tscorers.SCORERS["protgpt2"](tctx),
                   "ProtGPT2_score")


def test_unknown_preset_raises():
    _, tctx = _contexts(["A1C"], ["C"], "progen2-huge", {}, {})
    with pytest.raises(ValueError, match="Unknown ProGen2 preset progen2-huge"):
        tscorers.SCORERS["progen2"](tctx)
    tctx.checkpoint = "RITA_xxl"
    with pytest.raises(ValueError, match="Unknown RITA preset RITA_xxl"):
        tscorers.SCORERS["rita"](tctx)


def test_gpt2_checkpoint_loader_reads_hf_dirs_and_refuses_orbax(tmp_path):
    import json

    jc = jz.Gpt2Config(name="g", num_layers=2, embed_dim=32, num_heads=4, vocab_size=64,
                       n_ctx=40, dtype=jnp.float32)
    sd = gpt2_state(jc, seed=9)
    hf = tmp_path / "protgpt2_tiny"
    hf.mkdir()
    (hf / "config.json").write_text(json.dumps({"n_layer": 2, "n_embd": 32, "n_head": 4,
                                                "vocab_size": 64, "n_positions": 40}))
    torch.save(to_torch(sd), hf / "pytorch_model.bin")
    # the directory's shape, in the dtype of the config handed in (float32)
    model, config = tckpt.load_gpt2_checkpoint(hf, port_config(jc, tz.Gpt2Config), device=CPU)
    assert (config.name, config.num_layers, config.embed_dim, config.n_ctx, config.dtype) == (
        "protgpt2_tiny", 2, 32, 40, torch.float32)
    toks = np.random.default_rng(10).integers(0, 64, (2, 9))
    want = np.asarray(jz.gpt2_apply(jz.gpt2_convert_torch_state_dict(sd, jc), jc,
                                    jnp.asarray(toks, jnp.int32)))
    np.testing.assert_allclose(model(torch.from_numpy(toks)).numpy(), want, atol=ATOL, rtol=0)
    # a bare state dict file, read with the given config
    torch.save(to_torch(sd), tmp_path / "bare.pt")
    bare, _ = tckpt.load_gpt2_checkpoint(tmp_path / "bare.pt",
                                         port_config(jc, tz.Gpt2Config), device=CPU)
    np.testing.assert_allclose(bare(torch.from_numpy(toks)).numpy(), want, atol=ATOL, rtol=0)
    orbax = tmp_path / "orbax"
    (orbax / "params").mkdir(parents=True)
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_gpt2_checkpoint(orbax, device=CPU)


def test_tokenizer_extra_without_transformers_raises(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "transformers", None)
    _, tctx = _contexts(["A1C"], ["C"], None, {}, {"num_layers": 1, "embed_dim": 8,
                                                   "num_heads": 2, "tokenizer": "x"})
    monkeypatch.setattr(tz, "Gpt2Config", functools.partial(tz.Gpt2Config, dtype=torch.float32))
    with pytest.raises(RuntimeError, match="transformers"):
        tscorers.SCORERS["protgpt2"](tctx)
