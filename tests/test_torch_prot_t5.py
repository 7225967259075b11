"""ProtT5 in the port against the JAX package on the CPU, both sides loading
one HF-named state dict (T5EncoderModel / T5ForConditionalGeneration
layout): the encoder with the relu and the gated FFN, the decoder with a
tied and an untied head, the relative-position buckets as integers, and
the masked log-odds table VESPA reads. The JAX side runs inside
``jax.enable_x64(False)``, float32 as its CLI runs it."""

from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from proteingym_tpu.models import prot_t5 as jt5  # noqa: E402
from proteingym_tpu_torch.models import prot_t5 as tt5  # noqa: E402
from tests.test_torch_eve_train import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides through 2 layers; only the summation order differs
# (~1e-6); the planted fault (a d_kv**-0.5 softmax scale) moves them O(0.1)
HIDDEN_ATOL = 1e-4
LOGODDS_ATOL = 1e-4
TINY = tt5.PRESETS["prot_t5_tiny"]


def hf_state(config, seed, decoder_layers=0, tied=True):
    """A seeded HF-named state dict (numpy), with the entries an HF file
    holds beside ours (embed_tokens copies; a tied lm_head)."""
    model = tt5.init_random(config, seed=seed, device="cpu", decoder_layers=decoder_layers,
                            tied=tied)
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    sd["encoder.embed_tokens.weight"] = sd["shared.weight"]
    if decoder_layers:
        sd["decoder.embed_tokens.weight"] = sd["shared.weight"]
        if tied:
            sd["lm_head.weight"] = sd["shared.weight"].copy()
    return sd


def _both(sd):
    with jax.enable_x64(False):
        config = jt5.config_from_state_dict(sd)
        params = jt5.convert_torch_state_dict(sd, config)
    return config, params, tt5.load_state_dict(sd, device="cpu")


def _tokens(seed, b=3, t=14, vocab=48):
    rs = np.random.RandomState(seed)
    tokens = rs.randint(3, vocab, (b, t))
    tokens[0, 9:] = tt5.PAD_ID
    tokens[0, 8] = tt5.EOS_ID
    tokens[1:, -1] = tt5.EOS_ID
    return tokens


def _scaled_attend(q, k, v, bias):  # the planted fault: a softmax scale T5 has not
    return ORIGINAL_ATTEND(q * q.shape[-1] ** -0.5, k, v, bias)


ORIGINAL_ATTEND = tt5._attend


@pytest.mark.parametrize("gated", [False, True], ids=["relu", "gated"])
def test_encoder_matches_jax(gated):
    config = TINY if not gated else tt5.ProtT5Config(**{**TINY.__dict__, "gated": True})
    sd = hf_state(config, seed=3 + gated)
    jconfig, params, model = _both(sd)
    assert jconfig.gated == gated and model.config.gated == gated
    tokens = _tokens(1)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda p, t: jt5.apply(p, jconfig, t))(
            params, jnp.asarray(tokens, jnp.int32)))
    got = tt5.apply(model, torch.as_tensor(tokens)).numpy()
    live = tokens != tt5.PAD_ID
    np.testing.assert_allclose(got[live], want[live], atol=HIDDEN_ATOL, rtol=0)
    with mock.patch.object(tt5, "_attend", _scaled_attend):
        bad = tt5.apply(model, torch.as_tensor(tokens)).numpy()
    assert np.abs(bad[live] - want[live]).max() > 10 * HIDDEN_ATOL


@pytest.mark.parametrize("tied", [True, False], ids=["tied", "untied"])
def test_decoder_matches_jax(tied):
    sd = hf_state(TINY, seed=5, decoder_layers=2, tied=tied)
    jconfig, params, model = _both(sd)
    assert ("lm_head" in params["decoder"]) == (not tied)
    assert (model.lm_head is None) == tied
    enc_tokens = _tokens(2, b=2, t=10)
    dec_tokens = np.random.RandomState(3).randint(3, 48, (2, 5))
    dec_tokens[:, 0] = tt5.DECODER_START_ID
    with jax.enable_x64(False):
        def run(p, e, d):
            enc = jt5.apply(p, jconfig, e)
            return jt5.decoder_apply(p, jconfig, d, enc, e == jt5.PAD_ID)
        want = np.asarray(jax.jit(run)(params, jnp.asarray(enc_tokens, jnp.int32),
                                       jnp.asarray(dec_tokens, jnp.int32)))
    enc_t = torch.as_tensor(enc_tokens)
    got = tt5.decoder_apply(model, torch.as_tensor(dec_tokens), tt5.apply(model, enc_t),
                            enc_t == tt5.PAD_ID).numpy()
    np.testing.assert_allclose(got, want, atol=HIDDEN_ATOL, rtol=0)


def test_buckets_equal_as_integers_up_to_300():
    # bidirectional: the JAX table at T=300 holds every smaller T's as its
    # top-left corner (the buckets depend on key - query only)
    t = 300
    with jax.enable_x64(False):
        want = jt5.position_bias_buckets(t, jt5.PRESETS["prot_t5_xl"])
    got = tt5.position_bias_buckets(t, tt5.PRESETS["prot_t5_xl"])
    assert got.dtype.kind == "i" and np.array_equal(got, want)
    # unidirectional: the JAX decoder's formula is the bidirectional map's
    # past half at twice the buckets (32 of them, max_exact 16), so the JAX
    # function at num_buckets=64 on min(rel, 0) is the reference
    dec = tt5.decoder_buckets(t, tt5.PRESETS["prot_t5_xl"])
    rel = np.arange(t)[None, :] - np.arange(t)[:, None]
    with jax.enable_x64(False):
        want_dec = jt5._relative_position_bucket(np.minimum(rel, 0), num_buckets=64,
                                                 max_distance=128)
    assert dec.dtype.kind == "i" and np.array_equal(dec, want_dec)
    assert (dec[rel > 0] == 0).all() and dec.max() == 31


def test_masked_logodds_matches_jax():
    sd = hf_state(TINY, seed=7, decoder_layers=2)
    jconfig, params, model = _both(sd)
    seq = "MKTAYIAKQRQISFVKSHFSRQ"
    with jax.enable_x64(False), mock.patch.object(jt5, "apply", jax.jit(jt5.apply, static_argnums=1)), \
            mock.patch.object(jt5, "decoder_apply", jax.jit(jt5.decoder_apply, static_argnums=1)):
        want = jt5.masked_logodds(params, jconfig, seq, chunk=8)
    got = tt5.masked_logodds(model, seq, chunk=8)
    assert got.shape == (len(seq), TINY.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGODDS_ATOL, rtol=0)
    some = tt5.masked_logodds(model, seq, positions=[0, 5, 21])
    np.testing.assert_allclose(some, got[[0, 5, 21]], atol=1e-6, rtol=0)
    with mock.patch.object(tt5, "_attend", _scaled_attend):
        bad = tt5.masked_logodds(model, seq, chunk=8)
    assert np.abs(bad - want).max() > 10 * LOGODDS_ATOL
    emb = tt5.embeddings(model, seq).numpy()
    with jax.enable_x64(False):
        np.testing.assert_allclose(emb, np.asarray(jt5.embeddings(params, jconfig, seq)),
                                   atol=HIDDEN_ATOL, rtol=0)


def test_params_from_jax_round_trip():
    with jax.enable_x64(False):
        params = jt5.init_params(jax.random.PRNGKey(0), jt5.PRESETS["prot_t5_tiny"])
    sd = tt5.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    model = tt5.load_state_dict(sd, device="cpu")
    assert model.decoder is None and model.config.d_kv == TINY.d_kv
    tokens = _tokens(4)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(jt5.apply, static_argnums=1)(
            params, jt5.PRESETS["prot_t5_tiny"], jnp.asarray(tokens, jnp.int32)))
    got = tt5.apply(model, torch.as_tensor(tokens)).numpy()
    live = tokens != tt5.PAD_ID
    np.testing.assert_allclose(got[live], want[live], atol=HIDDEN_ATOL, rtol=0)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt5.init_random(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt5.load_state_dict(hf_state(TINY, seed=1))
