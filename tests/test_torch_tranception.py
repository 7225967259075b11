"""The port's Tranception (proteingym_tpu_torch.models.tranception) and its
AR harness (models/ar_scoring.py) against the JAX package's, on a tiny
float32 preset (the JAX side via ``dataclasses.replace(..., dtype=float32)``):
the slopes, ALiBi, the vocabulary, the depthwise convolution, the logits
through the HF state-dict bridge and from JAX's ``init_params``, the slice
plans, the batched log-likelihoods and the ``score_mutants_ar`` tables
(columns, rows, row order and values).

On CPU tensors the attention takes ``plain_mha`` and the JAX ``mha`` its
``reference_mha``, so these tests hold the model around K1 to the JAX
``apply``; K1 itself is held to the same plain version on the card.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import ar_scoring as jar
from proteingym_tpu.models import tranception as jt
from proteingym_tpu.pipeline import checkpoints as jckpt
from proteingym_tpu_torch.models import ar_scoring as tar
from proteingym_tpu_torch.models import tranception as tt
from proteingym_tpu_torch.pipeline import checkpoints as tckpt

# float32 on both sides; only summation orders differ (the depthwise
# convolution, the dense products, the softmax): ~1e-6 relative on logits
# of magnitude up to ~15
ATOL = 1e-4
# summed log-likelihoods of ~20-40 tokens and the score tables made of them
LL_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
TINY = tt.TranceptionConfig("tiny", 2, 64, 4, n_ctx=64, dtype=torch.float32)
JAX_TINY = jt.TranceptionConfig("tiny", 2, 64, 4, n_ctx=64, dtype=jnp.float32)


def hf_state(config, seed):
    """An HF Tranception state dict with every weight random (LN scales
    around 1), plus the tied LM head the port ignores, as numpy float32."""
    rng = np.random.default_rng(seed)
    d, f, hd = config.embed_dim, config.ffn_dim, config.head_dim

    def w(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    sd = {"transformer.wte.weight": w(25, d, scale=0.5)}
    for name in ["transformer.ln_f"] + [f"transformer.h.{i}.ln_{j}"
                                        for i in range(config.num_layers) for j in (1, 2)]:
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1 + w(d, scale=0.1), w(d, scale=0.1)
    for i in range(config.num_layers):
        p = f"transformer.h.{i}"
        for name, (n_in, n_out) in (("attn.c_attn", (d, 3 * d)), ("attn.c_proj", (d, d)),
                                    ("mlp.c_fc", (d, f)), ("mlp.c_proj", (f, d))):
            sd[f"{p}.{name}.weight"] = w(n_in, n_out, scale=n_in ** -0.5)
            sd[f"{p}.{name}.bias"] = w(n_out, scale=0.05)
        for ref in ("query", "key", "value"):
            for gi, kernel in enumerate(tt.CONV_KERNELS):
                sd[f"{p}.attn.{ref}_depthwiseconv.{gi}.conv.weight"] = w(hd, 1, kernel, scale=0.4)
                sd[f"{p}.attn.{ref}_depthwiseconv.{gi}.conv.bias"] = w(hd, scale=0.1)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    return sd


def _both(config=TINY, jconfig=JAX_TINY, seed=0):
    sd = hf_state(config, seed)
    return tt.load_hf_state_dict(sd, config, device="cpu"), jt.convert_torch_state_dict(sd, jconfig)


def _rows(rs, lengths, width):
    seqs = ["".join(AA[i] for i in rs.randint(0, 20, n)) for n in lengths]
    return np.stack([jt.VOCAB.tokenize(s, pad_to=width) for s in seqs])


@pytest.mark.parametrize("heads", [4, 8, 12, 16, 20, 24, 40])
def test_slopes_and_alibi_equal_jax(heads):
    for mode in ("grouped_alibi", "standard_alibi"):
        assert tt.get_slopes(heads, mode) == jt.get_slopes(heads, mode)
    got = tt.alibi_bias(heads, 300)
    assert got.dtype == torch.float32 and got.shape == (heads, 300)
    np.testing.assert_array_equal(got.numpy(), jt.alibi_bias(heads, 300)[:, 0])


def test_large_slopes_are_the_grouped_schedule():
    # Tranception-L: {0.25, 0.0625, 0.0156, 0.0039, 0.5} tiled x4, so the
    # bias reaches 0.5 * 1023 at T=1024
    slopes = tt.get_slopes(20)
    assert slopes[:5] == [0.25, 0.0625, 0.015625, 0.00390625, 0.5] and slopes == slopes[:5] * 4
    assert float(tt.alibi_bias(20, 1024).max()) == 511.5


def test_vocab_and_indeterminate_sampling_equal_jax():
    assert len(tt.VOCAB) == 25 and tt.VOCAB.tok_to_idx == jt.VOCAB.tok_to_idx
    for seq, pad in (("ACDXZ", None), ("MKLVBJU", 12)):
        np.testing.assert_array_equal(tt.VOCAB.tokenize(seq, pad), jt.VOCAB.tokenize(seq, pad))
    seq = "AXBJZQXXBZ" * 3
    for seed in range(3):
        assert (tt.sample_indeterminate(seq, np.random.default_rng(seed))
                == jt.sample_indeterminate(seq, np.random.default_rng(seed)))


@pytest.mark.parametrize("embed,heads", [(64, 4), (128, 8)], ids=["hd16", "hd16_grp2"])
def test_projection_and_depthwise_convs_equal_jax(embed, heads):
    # the nine convolutions of a layer run as one, over kernels padded to 7
    # taps, in place on the projection; q comes out times q_scale
    config = dataclasses.replace(TINY, embed_dim=embed, num_heads=heads)
    jconfig = dataclasses.replace(JAX_TINY, embed_dim=embed, num_heads=heads)
    model, jparams = _both(config, jconfig, seed=5)
    attn, layer = model.transformer.h[0].attn, jparams["layers"][0]
    x = np.random.RandomState(5).randn(2, 13, embed).astype(np.float32)
    with torch.no_grad():
        got = [z.numpy() for z in attn.qkv(torch.from_numpy(x))]
    hd, grp = config.head_dim, heads // 4
    qkv = jt._dense(jnp.asarray(x), layer["c_attn"])
    for i, (name, z) in enumerate(zip("qkv", jnp.split(qkv, 3, axis=-1))):
        z = z.reshape(2, 13, heads, hd).transpose(0, 2, 1, 3)
        want = [z[:, :grp]] + [
            jt._causal_depthwise_conv(z[:, (gi + 1) * grp:(gi + 2) * grp],
                                      layer["dwconv"][f"{name}{gi}"]) for gi in range(3)]
        want = np.concatenate([np.asarray(w) for w in want], axis=1)
        scale = attn.q_scale if name == "q" else 1.0
        assert got[i].shape == (2, heads, 13, hd)
        np.testing.assert_allclose(got[i], want * scale, atol=ATOL, rtol=0)
    assert attn.q_scale == 0.25


@pytest.mark.parametrize("embed,heads", [(64, 4), (128, 4)], ids=["hd16", "hd32"])
def test_logits_with_padded_rows_match_jax_through_state_dict(embed, heads):
    # hd16: q is scaled by the model (2^-2); hd32: 32^-0.5 is not a power of
    # two, so the scale goes to the attention
    config = dataclasses.replace(TINY, embed_dim=embed, num_heads=heads)
    jconfig = dataclasses.replace(JAX_TINY, embed_dim=embed, num_heads=heads)
    model, jparams = _both(config, jconfig, seed=1)
    assert model.transformer.h[0].attn.sm_scale == (1.0 if embed == 64 else 32 ** -0.5)
    tokens = _rows(np.random.RandomState(1), [30, 23, 7], 40)  # pad tails of 8, 15, 31
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    want = np.asarray(jt.apply(jparams, jconfig, jnp.asarray(tokens)))
    assert got.shape == (3, 40, 25) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_logits_match_jax_from_init_params():
    jparams = jt.init_params(jax.random.PRNGKey(3), JAX_TINY)
    jparams = jax.tree.map(  # random biases and LN parameters too
        lambda x: np.asarray(x) + np.random.RandomState(x.size % 97).randn(*x.shape)
        .astype(np.float32) * 0.05, jparams)
    model = tt.load_hf_state_dict(tt.params_from_jax(jparams, TINY), TINY, device="cpu")
    tokens = _rows(np.random.RandomState(3), [20, 13], 24)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens).long()).numpy()
    want = np.asarray(jt.apply(jparams, JAX_TINY, jnp.asarray(tokens)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_forward_is_causal_and_refuses_rows_past_n_ctx():
    model, _ = _both(seed=2)
    tokens = torch.from_numpy(_rows(np.random.RandomState(2), [20], 22)).long()
    changed = tokens.clone()
    changed[0, 15] = 7
    with torch.no_grad():
        a, b = model(tokens), model(changed)
    torch.testing.assert_close(a[:, :15], b[:, :15], atol=0, rtol=0)
    assert not torch.allclose(a[:, 15:], b[:, 15:])
    with pytest.raises(ValueError, match="at most 64"):
        model(torch.ones(1, 65, dtype=torch.long))


def test_init_random_is_seeded_and_on_the_requested_device():
    a = tt.init_random(TINY, seed=1, device="cpu").state_dict()
    b = tt.init_random(TINY, seed=1, device="cpu").state_dict()
    c = tt.init_random(TINY, seed=2, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["transformer.wte.weight"], c["transformer.wte.weight"])
    assert float(a["transformer.h.0.attn.c_attn.weight"].std()) == pytest.approx(0.02, rel=0.1)
    assert float(a["transformer.h.1.ln_2.weight"].min()) == 1.0
    assert set(a) == set(tt.params_from_jax(
        jax.tree.map(np.asarray, jt.init_params(jax.random.PRNGKey(0), JAX_TINY)), TINY))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.init_random(TINY, seed=1)  # the default is the card


def test_load_state_dict_fuses_the_convolutions_again():
    # the forward reads the fused (9 hd, 1, 7) convolution, a buffer outside
    # the state dict: torch's load_state_dict must refresh it
    sd = hf_state(TINY, 8)
    want_model = tt.load_hf_state_dict(sd, TINY, device="cpu")
    model = tt.init_random(TINY, seed=3, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                           if k != "lm_head.weight"})
    tokens = torch.from_numpy(_rows(np.random.RandomState(8), [11, 7], 16)).long()
    with torch.no_grad():
        np.testing.assert_array_equal(model(tokens).numpy(), want_model(tokens).numpy())


def test_checkpoint_specs(tmp_path):
    model, config = tckpt.load_tranception_checkpoint(None, device="cpu")
    assert (config.num_layers, config.embed_dim, config.num_heads) == (2, 64, 4)
    assert config.dtype == torch.float32
    for spec, jspec in (("Small", (12, 768, 12)), ("Large", (36, 1280, 20))):
        cfg = tckpt.TRANCEPTION_PRESETS[spec]
        assert cfg is tt.PRESETS[f"tranception_{spec.lower()}"]
        assert (cfg.num_layers, cfg.embed_dim, cfg.num_heads) == jspec
        assert cfg.dtype == torch.bfloat16
    sd = hf_state(TINY, 4)
    hf = tmp_path / "hf"
    hf.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, hf / "pytorch_model.bin")
    (hf / "config.json").write_text(json.dumps(
        {"model_type": "tranception", "n_layer": 2, "n_embd": 64, "n_head": 4, "n_ctx": 64}))
    model, config = tckpt.load_tranception_checkpoint(str(hf), device="cpu")
    assert config.n_ctx == 64 and config.dtype == torch.bfloat16  # HF weights run in bf16
    jparams, jconfig = jckpt.load_tranception_checkpoint(str(hf))
    assert (jconfig.num_layers, jconfig.embed_dim, jconfig.n_ctx) == (2, 64, 64)
    torch.testing.assert_close(model.transformer.h[1].attn.c_attn.weight.float(),
                               torch.from_numpy(sd["transformer.h.1.attn.c_attn.weight"])
                               .bfloat16().float())
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tckpt.load_tranception_checkpoint(str(tmp_path / "orbax"), device="cpu")


# ---------------------------------------------------------------------------
# The AR harness
# ---------------------------------------------------------------------------

def _assay(rs, length, n):
    target = "".join(AA[i] for i in rs.randint(0, 20, length))
    mutants, seqs = [], []
    for _ in range(n):
        picks = sorted(rs.choice(length, rs.randint(1, 3), replace=False))
        seq, toks = list(target), []
        for p in picks:
            to = AA[(AA.index(target[p]) + 1 + rs.randint(19)) % 20]
            toks.append(f"{target[p]}{p + 1}{to}")
            seq[p] = to
        mutants.append(":".join(toks))
        seqs.append("".join(seq))
    return target, mutants, seqs


def _plan_tuples(plans):
    return [(p.mutated_sequence, p.sliced_sequence, p.window_start, p.window_end)
            for p in plans]


@pytest.mark.parametrize("window,ctx", [("optimal", 20), ("optimal", 19), ("optimal", 80),
                                       ("sliding", 20)])
def test_sequence_slices_equal_jax(window, ctx):
    # ctx 19 is odd: interior windows are one short, so a WT window can
    # share its start with an edge window of another width
    target, mutants, seqs = _assay(np.random.RandomState(5), 50, 25)
    got = tar.get_sequence_slices(mutants, seqs, target, ctx, scoring_window=window)
    want = jar.get_sequence_slices(mutants, seqs, target, ctx, scoring_window=window)
    assert _plan_tuples(got) == _plan_tuples(want)
    # indel mode: whole rows and one WT row spanning the target, whatever
    # the window
    got = tar.get_sequence_slices(mutants, seqs, target, ctx, scoring_window=window,
                                  indel_mode=True)
    want = jar.get_sequence_slices(mutants, seqs, target, ctx, scoring_window=window,
                                   indel_mode=True)
    assert _plan_tuples(got) == _plan_tuples(want)


def test_length_buckets_equal_jax():
    lengths = np.arange(1, 200)
    np.testing.assert_array_equal(tar._length_buckets(lengths), jar._length_buckets(lengths))


def test_batched_loglik_matches_jax_across_buckets():
    # 13 rows over three buckets (32, 64 and 96 tokens), 4 per forward
    model, jparams = _both(seed=6)
    rs = np.random.RandomState(6)
    rows = [jt.VOCAB.tokenize("".join(AA[i] for i in rs.randint(0, 20, n)))
            for n in rs.randint(5, 62, 13)]
    got = tar.batched_ar_loglik(model, rows, jt.VOCAB.PAD, batch_size=4, device="cpu")
    want = jar.batched_ar_loglik(lambda t: jt.apply(jparams, JAX_TINY, t), rows,
                                 jt.VOCAB.PAD, batch_size=4)
    assert got.dtype == np.float64 and got.shape == (13,)
    np.testing.assert_allclose(got, want, atol=LL_ATOL, rtol=0)


def _assert_tables_equal(got, want):
    assert got.names == list(want.columns)
    assert got["mutated_sequence"].tolist() == want["mutated_sequence"].tolist()
    for name in got.names[1:]:
        np.testing.assert_allclose(got[name], want[name].to_numpy(), atol=LL_ATOL, rtol=0)


@pytest.mark.parametrize("window,ctx,mirror,with_wt", [
    ("optimal", 62, True, True),     # no windowing, the WT in the assay
    ("optimal", 30, True, False),    # optimal windows of 30 residues
    ("optimal", 29, False, True),    # an odd window, L->R only
    ("sliding", 30, True, True),     # two sliding windows summed
])
def test_score_mutants_ar_equals_the_jax_frame(window, ctx, mirror, with_wt):
    model, jparams = _both(seed=7)
    target, mutants, seqs = _assay(np.random.RandomState(7), 45, 12)
    if with_wt:  # a WT row between the mutants, as an assay may hold one
        mutants.insert(5, "A1A")
        seqs.insert(5, target)
    kw = dict(scoring_window=window, scoring_mirror=mirror, batch_size=8)
    got = tar.score_mutants_ar(model, tt.VOCAB.tokenize, tt.VOCAB.PAD, mutants, seqs, target,
                               ctx, device="cpu", **kw)
    want = jar.score_mutants_ar(lambda t: jt.apply(jparams, JAX_TINY, t),
                                jt.VOCAB.tokenize, jt.VOCAB.PAD, mutants, seqs, target, ctx,
                                **kw)
    _assert_tables_equal(got, want)
    assert (got["mutated_sequence"][-1] == target) == with_wt


def test_score_mutants_ar_without_a_target_sums_sliding_windows():
    model, jparams = _both(seed=8)
    _, mutants, seqs = _assay(np.random.RandomState(8), 40, 6)
    got = tar.score_mutants_ar(model, tt.VOCAB.tokenize, tt.VOCAB.PAD, mutants, seqs, None,
                               25, batch_size=4, device="cpu")
    want = jar.score_mutants_ar(lambda t: jt.apply(jparams, JAX_TINY, t),
                                jt.VOCAB.tokenize, jt.VOCAB.PAD, mutants, seqs, None, 25,
                                batch_size=4)
    _assert_tables_equal(got, want)
