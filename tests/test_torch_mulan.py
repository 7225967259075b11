"""The port's MULAN (proteingym_tpu_torch.models.mulan) against the JAX
package's, on a tiny float32 trunk (ESM2's ``esm2_tiny``: 2 x 128, 4 heads
of 32): the angle features and the struct grid, the adapter's output with
its pad key mask, the logits, ``score_mutants`` in batches, the
``StructEsmForMaskedLM`` loader (with and without the adapter's final LN)
over ``esm2.convert_hf_esm_state_dict``, the seeded JAX init through
``params_from_jax``, ESM2's ``extra_embedding`` (shared and per row), the
legacy additive scorer, and the scorer's column with ``angles_dir=``.

One weight set for both sides; the JAX side runs inside
``jax.enable_x64(False)``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import mulan as jm
from proteingym_tpu.models import structure_plms as jsp
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import mulan as tm
from proteingym_tpu_torch.models import structure_plms as tsp
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides: logits agree to ~1e-6 relative; a score is a log
# ratio of two probabilities
ATOL = 1e-4
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
JC = jm.MulanConfig(name="mulan_test", esm=jesm.PRESETS["esm2_tiny"])
TC = tm.MulanConfig(name="mulan_test", esm=tesm.PRESETS["esm2_tiny"])


def struct_esm_state(c=TC, seed=0, final_ln=False):
    """A random ``StructEsmForMaskedLM`` state dict (transformers' names,
    numpy): the ESM trunk under ``esm.``, the adapter under
    ``esm.embeddings.struct_embeddings.``, the tied decoder."""
    rng = np.random.default_rng(seed)
    d, n = c.esm.embed_dim, c.esm.num_layers
    sd = {}

    def dense(key, n_in, n_out):
        w = rng.standard_normal((n_out, n_in)) / np.sqrt(n_in)
        sd[f"{key}.weight"] = w.astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.standard_normal(n_out)).astype(np.float32)

    def ln(key):
        sd[f"{key}.weight"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
        sd[f"{key}.bias"] = (0.1 * rng.standard_normal(d)).astype(np.float32)

    def layer(p):
        ln(f"{p}.attention.LayerNorm")
        for name in ("query", "key", "value"):
            dense(f"{p}.attention.self.{name}", d, d)
        dense(f"{p}.attention.output.dense", d, d)
        ln(f"{p}.LayerNorm")
        dense(f"{p}.intermediate.dense", d, 4 * d)
        dense(f"{p}.output.dense", 4 * d, d)

    sd["esm.embeddings.word_embeddings.weight"] = (0.3 * rng.standard_normal(
        (c.esm.alphabet_size, d))).astype(np.float32)
    for i in range(n):
        layer(f"esm.encoder.layer.{i}")
    ln("esm.encoder.emb_layer_norm_after")
    dense("lm_head.dense", d, d)
    ln("lm_head.layer_norm")
    sd["lm_head.bias"] = (0.1 * rng.standard_normal(c.esm.alphabet_size)).astype(np.float32)
    sd["lm_head.decoder.weight"] = sd["esm.embeddings.word_embeddings.weight"]
    se = "esm.embeddings.struct_embeddings"
    dense(f"{se}.MLP", tm.STRUCT_DIM, d)
    for i in range(c.struct_layers):
        layer(f"{se}.encoder.layer.{i}")
    if final_ln:
        ln(f"{se}.encoder.emb_layer_norm_after")
    return sd


def both(sd):
    with F32():
        params = jm.convert_torch_state_dict(sd, JC)
    return params, tm.load_torch_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, TC,
                                            device=CPU)


def helix(n, seed):
    coords = synthetic_helix_backbone(n, seed=seed)
    coords[:, 1] += 0.05 * np.random.RandomState(seed).randn(n, 3)
    return coords


def _rows(b, t, seed):
    rng = np.random.default_rng(seed)
    toks, feats = [], []
    for i in range(b):
        n = t - 2 - 3 * i
        coords = helix(n, seed + i)
        row = tesm.ALPHABET.tokenize("".join(rng.choice(list(AA), n)), pad_to=t)
        row[1 + rng.choice(n, 2, replace=False)] = tesm.ALPHABET.mask_idx
        grid = np.full((t, 7), tm.PAD_VALUE, np.float32)
        grid[:n + 2] = tm.build_struct_features(tm.backbone_angle_features(coords))
        toks.append(row)
        feats.append(grid)
    return np.stack(toks), np.stack(feats)


def test_angles_and_struct_grid_match_jax():
    coords = helix(30, 1)
    got, want = tm.backbone_angle_features(coords), jm.backbone_angle_features(coords)
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[0, 0]) and np.isnan(got[-1, 1]) and np.isnan(got[:, 2:]).all()
    assert np.isfinite(got[1:, 0]).all() and np.isfinite(got[:-1, 1]).all()
    ragged = np.random.default_rng(2).standard_normal((30, 5))
    ragged[3, 1] = np.nan
    for angles in (got, ragged):
        grid = tm.build_struct_features(angles)
        np.testing.assert_array_equal(grid, jm.build_struct_features(angles))
    assert grid.shape == (32, 7) and (grid[0] == 4.0).all() and (grid[1:-1, 5:] == 4.0).all()
    assert grid[4, 1] == np.float32(np.deg2rad(182.0))


@pytest.mark.parametrize("final_ln", [False, True], ids=["plain", "final_ln"])
def test_adapter_and_logits_match_jax(final_ln):
    params, model = both(struct_esm_state(seed=3, final_ln=final_ln))
    assert hasattr(model.struct_embeddings.encoder, "emb_layer_norm_after") == final_ln
    toks, feats = _rows(3, 26, seed=4)
    mask = toks != tesm.ALPHABET.padding_idx
    with F32():
        want_adapter = np.asarray(jm.struct_embeddings(params["struct"], JC, jnp.asarray(feats),
                                                       jnp.asarray(mask)))
        want = np.asarray(jm.apply(params, JC, jnp.asarray(toks), jnp.asarray(feats)))
    with torch.no_grad():
        got_adapter = model.struct_embeddings(torch.from_numpy(feats), torch.from_numpy(mask))
        got = model(torch.from_numpy(toks).long(), torch.from_numpy(feats))
    np.testing.assert_allclose(got_adapter.numpy(), want_adapter, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_extra_embedding_shared_and_per_row_matches_jax():
    sd = struct_esm_state(seed=5)
    with F32():
        params = jesm.convert_hf_esm_state_dict(sd, JC.esm)
    model = tesm.load_fair_esm_state_dict(tesm.convert_hf_esm_state_dict(sd, TC.esm), TC.esm,
                                          device=CPU)
    toks, _ = _rows(2, 20, seed=6)
    rng = np.random.default_rng(7)
    for cond in (rng.standard_normal((24, 128)), rng.standard_normal((2, 20, 128))):
        cond = cond.astype(np.float32)
        with F32():
            want = np.asarray(jesm.apply(params, JC.esm, jnp.asarray(toks),
                                         extra_embedding=jnp.asarray(cond)))
        with torch.no_grad():
            got = model(torch.from_numpy(toks).long(), extra_embedding=torch.from_numpy(cond))
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    untied = dict(sd, **{"lm_head.decoder.weight": sd["lm_head.decoder.weight"] + 1})
    with pytest.raises(ValueError, match="untied"):
        tesm.convert_hf_esm_state_dict(untied, TC.esm)


def _assay(length=24, seed=8):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), length))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, length, 3) for a in "AW" if a != seq[p]]
    return seq, muts + [f"{seq[1]}2K:{seq[6]}7P", f"{seq[0]}1{seq[0]}"]


def test_score_mutants_match_jax():
    params, model = both(struct_esm_state(seed=9))
    seq, muts = _assay()
    angles = tm.backbone_angle_features(helix(len(seq), 10))
    with F32():
        want = jm.score_mutants(params, JC, seq, angles, muts, batch_size=5)
    got = tm.score_mutants(model, seq, angles, muts, batch_size=5)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    # batches hold rows to themselves
    np.testing.assert_allclose(tm.score_mutants(model, seq, angles, muts, batch_size=64), got,
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="WT mismatch"):
        tm.score_mutants(model, seq, angles, [f"{'A' if seq[0] != 'A' else 'C'}1G"])


def test_seeded_jax_init_through_params_from_jax():
    with F32():
        params = jax.device_get(jm.init_params(jax.random.PRNGKey(11), JC))
    model = tm._empty(TC, CPU)
    copy_state_dict(model, tm.params_from_jax(params, TC), TC.name)
    toks, feats = _rows(2, 18, seed=12)
    with F32():
        want = np.asarray(jm.apply(params, JC, jnp.asarray(toks), jnp.asarray(feats)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long(), torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    rnd = tm.init_random(tm.PRESETS["mulan_tiny"], seed=0, device=CPU)
    w = rnd.struct_embeddings.encoder.layer[0].attention.self.query.weight
    assert abs(float(w.std()) / 0.02 - 1) < 0.05
    assert rnd.esm.embed_tokens.weight.dtype == torch.float32


def test_legacy_additive_scores_match_jax():
    jc, tc = jesm.PRESETS["esm2_tiny"], tesm.PRESETS["esm2_tiny"]
    with F32():
        params = jax.device_get(jsp.mulan_init(jax.random.PRNGKey(13), jc))
    model = tsp.AngleConditionedEsm(tesm.load_fair_esm_state_dict(
        tesm.params_from_jax(params, tc), tc, device=CPU))
    with torch.no_grad():
        model.angle_adapter.weight.copy_(torch.from_numpy(np.array(params["angle_adapter"]["w"]).T))
        model.angle_adapter.bias.copy_(torch.from_numpy(np.array(params["angle_adapter"]["b"])))
    seq, muts = _assay(22, seed=14)
    coords = helix(len(seq), 15)
    with F32():
        want = jsp.mulan_score_assay(params, jc, coords, seq, muts, chunk=7)
    got = tsp.mulan_score_assay(model, coords, seq, muts, chunk=7)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    assert got[-1] == 0.0


def test_scorer_column_matches_jax(tmp_path, monkeypatch):
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.data.structures import write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_prosst import _contexts

    sd = struct_esm_state(seed=16)
    params, _ = both(sd)
    seq, muts = _assay(20, seed=17)
    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", helix(len(seq), 18), seq)
    monkeypatch.setattr(jm, "init_params", lambda rng, c: params)
    monkeypatch.setattr(jesm, "PRESETS", dict(jesm.PRESETS, esm2_t6_8M=JC.esm))
    monkeypatch.setitem(tm.PRESETS, "mulan_tiny", dataclasses.replace(TC, name="mulan_tiny"))
    port_extra = {"params": {k: torch.from_numpy(v) for k, v in sd.items()}}
    for angles_dir in (None, tmp_path / "angles"):
        extra = {}
        if angles_dir is not None:
            angles_dir.mkdir()
            ang = np.random.default_rng(19).uniform(-3, 3, (len(seq), 7))
            ang[2, 3] = np.nan
            np.save(angles_dir / "SYN.npy", ang)
            extra = {"angles_dir": str(angles_dir)}
        jctx, tctx = _contexts(seq, muts, None, extra, dict(extra, **port_extra),
                               structure_dir=tmp_path / "pdb")
        with F32():
            want = jextra.score_mulan(jctx)["MULAN_score"].to_numpy()
        got = tscorers.SCORERS["mulan"](tctx)
        assert list(got) == ["MULAN_score"]
        np.testing.assert_allclose(got["MULAN_score"], want, atol=SCORE_ATOL, rtol=0)
