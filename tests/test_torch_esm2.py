"""The port's ESM model (proteingym_tpu_torch.models.esm2) against the JAX
``esm2.apply`` on the same weights.

Weights cross through one bridge: a fair-esm-layout state dict of numpy
arrays made from a seed. The JAX side loads it with
``convert_torch_state_dict``, the port with ``load_fair_esm_state_dict``.
Everything runs in float32 on the CPU.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu_torch.models import esm2 as tesm

ATOL = 1e-4  # float32 logits through a few layers on both sides

CONFIGS = {
    "esm2": (jesm.PRESETS["esm2_tiny"], tesm.PRESETS["esm2_tiny"]),
    "esm1b": (
        jesm.EsmConfig("esm1b_tiny", 2, 64, 4, use_rotary=False,
                       emb_layer_norm_before=True, dtype=jnp.float32),
        tesm.EsmConfig("esm1b_tiny", 2, 64, 4, use_rotary=False,
                       emb_layer_norm_before=True, dtype=torch.float32),
    ),
    "esm1v": (
        jesm.EsmConfig("esm1v_tiny", 3, 64, 4, use_rotary=False,
                       emb_layer_norm_before=False, dtype=jnp.float32),
        tesm.EsmConfig("esm1v_tiny", 3, 64, 4, use_rotary=False,
                       emb_layer_norm_before=False, dtype=torch.float32),
    ),
}


def fair_esm_state(config, seed):
    """Random fair-esm-named state dict (numpy) for ``config``; extra keys a
    real checkpoint carries are included and must be ignored."""
    with torch.device("meta"):
        names = tesm.EsmModel(config).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in names.items():
        shape = tuple(p.shape)
        if name.endswith("layer_norm.weight") or "layer_norm_" in name and name.endswith(".weight"):
            sd[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif len(shape) == 2 and "embed" not in name:
            sd[name] = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        else:
            sd[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    sd["lm_head.weight"] = sd["embed_tokens.weight"]
    sd["contact_head.regression.weight"] = np.zeros((1, 8), np.float32)
    return sd


def tokens_batch(seed, b=3, t=24):
    """Rows of different lengths (cls + residues + eos + pads), some masked."""
    rng = np.random.default_rng(seed)
    a = tesm.ALPHABET
    rows = []
    for i in range(b):
        n = t - 2 - 3 * i
        seq = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n))
        row = a.tokenize(seq, pad_to=t)
        row[1 + rng.choice(n, size=2, replace=False)] = a.mask_idx
        rows.append(row)
    return np.stack(rows).astype(np.int32)


def _pair(kind, seed=0):
    jcfg, tcfg = CONFIGS[kind]
    sd = fair_esm_state(tcfg, seed)
    return (jesm.convert_torch_state_dict(sd, jcfg), jcfg,
            tesm.load_fair_esm_state_dict(sd, tcfg), tcfg, sd)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_logits_match_jax_apply(kind):
    params, jcfg, model, _, _ = _pair(kind)
    toks = tokens_batch(1)
    want = np.asarray(jesm.apply(params, jcfg, jnp.asarray(toks)))
    got = model(torch.from_numpy(toks).long())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_representations_match_jax(kind):
    params, jcfg, model, tcfg, _ = _pair(kind, seed=2)
    toks = tokens_batch(3)
    want_logits, want = jesm.apply(params, jcfg, jnp.asarray(toks), return_representations=True)
    got_logits, got = model(torch.from_numpy(toks).long(), return_representations=True)
    assert sorted(got) == sorted(want) == list(range(1, tcfg.num_layers + 1))
    for i in got:
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_padding_invariance(kind):
    _, _, model, _, _ = _pair(kind, seed=4)
    toks = tokens_batch(5, b=1, t=20)
    padded = np.concatenate([toks, np.full((1, 9), tesm.ALPHABET.padding_idx, np.int32)], 1)
    alone = model(torch.from_numpy(toks).long())
    inside = model(torch.from_numpy(padded).long())[:, :20]
    torch.testing.assert_close(inside, alone, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_segment_ids_match_per_sequence_forwards(kind):
    params, jcfg, model, _, _ = _pair(kind, seed=6)
    a = tesm.ALPHABET
    seqs = ["MKTAYIAKQR", "GLIEVQAPILSRVG", "DNLSG"]
    parts = [a.tokenize(s) for s in seqs]
    parts[1][3] = a.mask_idx  # per-segment token-dropout scale
    row = np.concatenate(parts + [np.full(4, a.padding_idx, np.int32)])
    seg = np.concatenate([np.full(len(p), i + 1, np.int32) for i, p in enumerate(parts)]
                         + [np.zeros(4, np.int32)])
    packed = model(torch.from_numpy(row[None]).long(),
                   segment_ids=torch.from_numpy(seg[None]))[0]
    start = 0
    for p in parts:
        solo = model(torch.from_numpy(p[None]).long())[0]
        torch.testing.assert_close(packed[start:start + len(p)], solo, atol=1e-5, rtol=0)
        start += len(p)
    want = np.asarray(jesm.apply(params, jcfg, jnp.asarray(row[None]),
                                 segment_ids=jnp.asarray(seg[None])))[0]
    live = seg > 0
    np.testing.assert_allclose(packed.numpy()[live], want[live], atol=ATOL, rtol=0)


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_params_from_jax_round_trip(kind):
    params, _, model, tcfg, sd = _pair(kind, seed=8)
    back = tesm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(back[name].numpy(), sd[name])
    again = tesm.load_fair_esm_state_dict(back, tcfg)
    toks = torch.from_numpy(tokens_batch(9)).long()
    torch.testing.assert_close(again(toks), model(toks), atol=0, rtol=0)


def test_missing_checkpoint_key_raises():
    _, tcfg = CONFIGS["esm2"]
    sd = fair_esm_state(tcfg, 0)
    del sd["layers.1.fc2.bias"]
    with pytest.raises(KeyError, match="layers.1.fc2.bias"):
        tesm.load_fair_esm_state_dict(sd, tcfg)


def test_random_init_is_seeded_and_typed():
    cfg = tesm.EsmConfig("esm2_bf16_tiny", 2, 64, 4)  # bf16 dense weights
    a = tesm.init_random(cfg, seed=3)
    b = tesm.init_random(cfg, seed=3)
    c = tesm.init_random(cfg, seed=4)
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert not torch.equal(a.layers[0].fc1.weight, c.layers[0].fc1.weight)
    assert a.layers[0].fc1.weight.dtype == torch.bfloat16
    assert a.layers[0].final_layer_norm.weight.dtype == torch.float32
    assert a.lm_head.bias.dtype == torch.float32
    logits = a(torch.from_numpy(tokens_batch(0)).long())
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
