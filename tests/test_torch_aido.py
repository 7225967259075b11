"""The port's AIDO trunk and scoring (proteingym_tpu_torch.models.structure_plms)
against the JAX package's, on a tiny float32 ``AidoConfig`` (2 layers x 64,
4 heads, 4 gated experts of 32, top 2) through ``aido_params_from_jax``:
the forward with padded rows (the routed experts against the JAX dense
route), the window starts, the sliding table on a sequence longer than
the published 768-residue window (the snapped last window's overlap
averaged), the two temperatures, and the scores with and without the
weighted alignment prior at 0.3. The JAX side runs inside ``jax.enable_x64(False)``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import structure_plms as jsp
from proteingym_tpu_torch.models import esm2
from proteingym_tpu_torch.models import structure_plms as tsp
from tests.test_torch_esm3 import _randomize
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides through 2 layers: summation order only
ATOL = 1e-5
AA = "ACDEFGHIKLMNPQRSTVWY"
SHAPE = dict(num_layers=2, embed_dim=64, num_heads=4, ffn_dim=32, num_experts=4, top_k=2)
JCFG = jsp.AidoConfig(name="aido_tiny", dtype=jnp.float32, **SHAPE)
TCFG = tsp.AidoConfig(name="aido_tiny", dtype=torch.float32, **SHAPE)


def native():
    """The tiny config's seeded JAX params (numpy leaves) and the port's
    model on the same weights."""
    with F32():
        params = _randomize(jsp.aido_init(jax.random.PRNGKey(2), JCFG), 2, unit_matrices=True)
    params = jax.tree_util.tree_map(np.asarray, params)
    return params, tsp.aido_load_state_dict(tsp.aido_params_from_jax(params, TCFG), TCFG, "cpu")


@pytest.fixture(scope="module")
def both():
    return native()


def test_forward_matches_jax(both):
    params, model = both
    rs = np.random.RandomState(3)
    tokens = rs.randint(4, 24, (3, 20))
    tokens[:, 0], tokens[:, -1] = esm2.ALPHABET.cls_idx, esm2.ALPHABET.eos_idx
    tokens[2, 15:] = esm2.ALPHABET.padding_idx  # a padded row: its keys masked
    with F32():
        want = np.asarray(jax.jit(lambda p, t: jsp.aido_apply(p, JCFG, t))(params, tokens))
    with torch.no_grad():
        got = model(torch.as_tensor(tokens))
    assert got.dtype == torch.float32 and got.shape == (3, 20, 33)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("n", [1, 250, 767, 768, 769, 1000, 1536, 1600, 2400])
def test_sliding_starts_equal_jax(n):
    assert tsp.aido_sliding_starts(n) == jsp.aido_sliding_starts(n)


def _assay(length, seed):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), length))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, length, 2) for a in "DW" if a != seq[p]]
    return seq, muts + [f"{seq[1]}2K:{seq[30]}31P"]


def test_table_and_temperatures_match_jax(both):
    """One published window over 40 residues (every row masked once, a
    ragged last chunk), then the scores at the two temperatures: the
    mutant's 1.0 and the WT's 1.5 differ, so each term moves the score."""
    params, model = both
    seq, muts = _assay(40, 4)
    tokens = np.asarray([esm2.ALPHABET.get_idx(a) for a in seq], np.int32)
    with F32():
        want = jsp._aido_raw_logits_table(params, JCFG, tokens, chunk=6, window=768)
    got = tsp.aido_logits_table(model, seq, chunk=6)
    assert got.dtype == np.float64 and got.shape == (40, 33)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got.any(axis=1).all()
    aa_to_idx = {a: esm2.ALPHABET.get_idx(a) for a in AA}
    with F32():
        want_s = jsp.aido_scores_from_table(seq, want, muts, aa_to_idx, 1, 1.0, 1.5)
    got_s = tsp.aido_scores_from_table(seq, got, muts, aa_to_idx)
    np.testing.assert_allclose(got_s, want_s, atol=ATOL, rtol=0)
    assert (tsp.AIDO_TEMP_MT, tsp.AIDO_TEMP_WT) == (1.0, 1.5)
    with F32():  # one temperature for both terms gives other scores
        same = jsp.aido_scores_from_table(seq, want, muts, aa_to_idx, 1, 1.0, 1.0)
    assert np.abs(got_s - same).max() > 1e-3
    with pytest.raises(ValueError):
        tsp.aido_scores_from_table(seq, got, ["WT"], {a: 0 for a in AA})


def test_overlapping_windows_match_jax(both):
    """L=800 with the published window: windows at 0 and 32, positions
    32-767 in both, their logits averaged (a few positions only, the
    ``positions`` argument of the sliding function)."""
    params, model = both
    rng = np.random.default_rng(7)
    tokens = np.asarray([esm2.ALPHABET.get_idx(a) for a in rng.choice(list(AA), 800)], np.int32)
    positions = [0, 31, 32, 400, 767, 768, 799]
    al = esm2.ALPHABET

    def wrap(grids):  # CLS and EOS around each window, as the scorers do
        full = np.full((grids.shape[0], grids.shape[1] + 2), al.eos_idx, np.int32)
        full[:, 0], full[:, 1:-1] = al.cls_idx, grids
        return full

    with F32():
        step = jax.jit(lambda p, t: jsp.aido_apply(p, JCFG, t))
        want = jsp.aido_logits_table_sliding(
            lambda g: np.asarray(step(params, wrap(g)))[:, 1:-1], tokens, 33, al.mask_idx,
            chunk=4, positions=positions)
    with torch.no_grad():
        got = tsp.aido_logits_table_sliding(
            lambda g: model(torch.as_tensor(wrap(g)).long())[:, 1:-1], tokens, 33, al.mask_idx,
            chunk=4, positions=positions)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert tsp.aido_sliding_starts(800) == [0, 32]
    # each call's logits its own number: the overlapped rows average their two windows
    calls = []

    def numbered(grids):
        calls.append(grids.copy())
        return np.full(grids.shape + (33,), float(len(calls) - 1))

    table = tsp.aido_logits_table_sliding(numbered, tokens, 33, al.mask_idx, chunk=4,
                                          positions=positions)
    assert len(calls) == 4 and all(c.shape == (4, 768) for c in calls)  # the last padded
    # window 0: [0, 31, 32, 400] call 0, [767] call 1; window 32: [32, 400, 767, 768] call 2,
    # [799] call 3
    expect = {0: 0, 31: 0, 32: 1, 400: 1, 767: 1.5, 768: 2, 799: 3}
    for pos, value in expect.items():
        assert (table[pos] == value).all(), pos
    assert not table[np.setdiff1d(np.arange(800), positions)].any()


@pytest.mark.parametrize("msa", [False, True])
def test_score_assay_matches_jax(both, msa):
    params, model = both
    seq, muts = _assay(40, 5)
    rs = np.random.RandomState(6)
    rows = ["".join(rs.choice(list(AA + "-"), 40)) for _ in range(9)] if msa else None
    weights = rs.uniform(0.2, 1.0, 9) if msa else None
    with F32():
        want = jsp.aido_score_assay(params, JCFG, seq, muts, msa_sequences=rows,
                                    msa_weights=weights, chunk=8)
    got = tsp.aido_score_assay(model, seq, muts, msa_sequences=rows, msa_weights=weights,
                               chunk=8)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.isfinite(got).all() and len(set(got)) > len(got) // 2


def test_presets_and_seeded_init():
    full = tsp.AidoConfig()
    assert (full.num_layers, full.embed_dim, full.num_heads, full.head_dim, full.ffn_dim,
            full.num_experts, full.top_k, full.dtype) == (8, 512, 8, 64, 1024, 8, 2,
                                                          torch.bfloat16)
    jfull = jsp.AidoConfig()
    assert {f.name: getattr(full, f.name) for f in dataclasses.fields(full) if f.name != "dtype"} \
        == {f.name: getattr(jfull, f.name) for f in dataclasses.fields(jfull) if f.name != "dtype"}
    model = tsp.aido_init(dataclasses.replace(full, num_layers=1), seed=0, device="cpu")
    assert model.layers[0].qkv.weight.dtype == torch.bfloat16
    expert = model.layers[0].moe.experts[0].w1.weight
    assert expert.dtype == torch.float32 and abs(float(expert.std()) / 0.02 - 1) < 0.02
    assert float(model.final_ln.weight.min()) == 1.0 and not model.final_ln.bias.any()
    tokens = torch.as_tensor(esm2.ALPHABET.tokenize("MKTAYIAKQR")[None])
    with torch.no_grad():
        out = model(tokens)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
