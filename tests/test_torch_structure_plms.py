"""The port's MIF / MIF-ST (proteingym_tpu_torch.models.structure_plms) and
its structure features (ops/gnn.knn_graph, ops/gvp) against the JAX
package's: the kNN indices (the tie order on the noiseless ideal helix,
whose CA distances tie in pairs, and on noisy ones), the node and edge
features, ``mif_structure_features``, the logits of a narrow float32 CARP
with the structure projection, ``mif_score_assay`` (the division by the
number of mutated positions), the seeded JAX init through
``mif_params_from_jax``, and both scorers' columns and presets.

The JAX side runs inside ``jax.enable_x64(False)`` (its kNN in float32,
as in production).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import carp as jc
from proteingym_tpu.models import structure_plms as jsp
from proteingym_tpu.ops import gnn as jgnn
from proteingym_tpu.ops import gvp as jgvp
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import carp as tc
from proteingym_tpu_torch.models import structure_plms as tsp
from proteingym_tpu_torch.ops import gnn as tgnn
from proteingym_tpu_torch.ops import gvp as tgvp
from tests.test_torch_esm3 import _randomize
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides through 3 ByteNet blocks: summation order only
ATOL = 1e-4
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
JCFG = jc.CarpConfig("mif_tiny", num_layers=3, embed_dim=32, max_dilation=4, dtype=jnp.float32)
TCFG = tc.CarpConfig("mif_tiny", num_layers=3, embed_dim=32, max_dilation=4, dtype=torch.float32)


def ideal_helix(n):
    """The helix with its N, C and O noise only: CA distances tie."""
    return synthetic_helix_backbone(n, seed=0)


def noisy_helix(n, seed, noise=0.05):
    coords = synthetic_helix_backbone(n, seed=seed)
    coords[:, 1] += noise * np.random.RandomState(seed).randn(n, 3)
    return coords


@pytest.mark.parametrize("coords", ["ideal", "noisy"])
def test_knn_indices_equal_jax(coords):
    ca = (ideal_helix(40) if coords == "ideal" else noisy_helix(40, 1))[:, 1]
    with F32():
        want = np.asarray(jgnn.knn_graph(jnp.asarray(ca), 16))
        short = np.asarray(jgnn.knn_graph(jnp.asarray(ca[:9]), 16))
    got = tgnn.knn_graph(torch.as_tensor(ca, dtype=torch.float32), 16).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tgnn.knn_graph(torch.as_tensor(ca[:9], dtype=torch.float32), 16).numpy(), short)
    assert short.shape == (9, 8)
    if coords == "ideal":  # the ideal helix's neighbours tie in pairs: i - j and i + j
        d2 = ((ca[:, None] - ca[None]) ** 2).sum(-1).astype(np.float32)
        assert np.isclose(d2[20, 19], d2[20, 21], rtol=1e-6)


def test_node_edge_and_mif_features_equal_jax():
    coords = noisy_helix(30, 2)
    for got, want in zip(tgvp.backbone_node_features(coords), jgvp.backbone_node_features(coords)):
        np.testing.assert_array_equal(got, want)
    e_idx = np.random.RandomState(3).randint(0, 30, (30, 7))
    for got, want in zip(tgvp.backbone_edge_features(coords, e_idx),
                         jgvp.backbone_edge_features(coords, e_idx)):
        np.testing.assert_array_equal(got, want)
    for c in (coords, ideal_helix(30)):
        with F32():
            want = jsp.mif_structure_features(c)
        got = tsp.mif_structure_features(c)
        assert got.shape == (30, tsp.MIF_FEAT_DIM) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def native(seed=0):
    with F32():
        params = _randomize(jsp.mif_init(jax.random.PRNGKey(seed), JCFG, tsp.MIF_FEAT_DIM), seed)
    return params, tsp.mif_load_state_dict(tsp.mif_params_from_jax(params, TCFG), TCFG,
                                           device=CPU)


def _assay(length=24, seed=5):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), length))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, length, 3) for a in "AW" if a != seq[p]]
    return seq, muts + [f"{seq[1]}2K:{seq[6]}7P:{seq[9]}10G", f"{seq[0]}1{seq[0]}"]


def test_logits_and_scores_match_jax():
    params, model = native(seed=4)
    seq, muts = _assay()
    coords = noisy_helix(len(seq), 6)
    feats = tsp.mif_structure_features(coords)
    toks = tc.CarpTokenizer().encode(seq)[None]
    with F32():
        want = np.asarray(jsp.mif_apply(params, JCFG, jnp.asarray(toks), jnp.asarray(feats)))
        want_scores = jsp.mif_score_assay(params, JCFG, coords, seq, muts)
    with torch.no_grad():
        got = model(torch.from_numpy(toks).long(), torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    got_scores = tsp.mif_score_assay(model, coords, seq, muts)
    np.testing.assert_allclose(got_scores, want_scores, atol=SCORE_ATOL, rtol=0)
    singles = tsp.mif_score_assay(model, coords, seq, muts[-2].split(":"))
    np.testing.assert_allclose(got_scores[-2], singles.mean(), atol=1e-6, rtol=0)
    assert got_scores[-1] == 0.0
    with pytest.raises(ValueError):
        tsp.mif_score_assay(model, coords, seq, ["WT"])
    # the structure moves the logits
    with torch.no_grad():
        bare = model(torch.from_numpy(toks).long(), torch.zeros_like(torch.from_numpy(feats)))
    assert not np.allclose(bare.numpy(), got, atol=1e-3)


def test_seeded_init_and_presets():
    for name, (layers, width, dil) in {"mif": (8, 256, 32), "mif_st": (16, 512, 64)}.items():
        c = tsp.MIF_PRESETS[name]
        assert (c.num_layers, c.embed_dim, c.max_dilation, c.dtype) == \
            (layers, width, dil, torch.bfloat16)
    model = tsp.mif_init(dataclasses.replace(tsp.MIF_PRESETS["mif"], num_layers=2), seed=0,
                         device=CPU)
    w = model.struct_proj.weight
    assert w.dtype == torch.float32 and w.shape == (256, tsp.MIF_FEAT_DIM)
    assert abs(float(w.std()) / 0.02 - 1) < 0.1 and not model.struct_proj.bias.any()
    assert model.embedder.embedder.weight.dtype == torch.bfloat16
    seq, muts = _assay(16, seed=7)
    scores = tsp.mif_score_assay(model, noisy_helix(16, 8), seq, muts)
    assert np.isfinite(scores).all()


@pytest.mark.parametrize("variant,column", [("mif", "MIF_score"), ("mif_st", "MIF_ST_score")])
def test_scorer_columns_match_jax(tmp_path, monkeypatch, variant, column):
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.data.structures import write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_prosst import _contexts

    params, model = native(seed=9)
    seq, muts = _assay(20, seed=10)
    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", noisy_helix(len(seq), 11), seq)
    # both scorers at the narrow float32 shape: the JAX one builds its
    # CarpConfig inside the function, the port's reads MIF_PRESETS
    monkeypatch.setattr(jc, "CarpConfig",
                        lambda name, *a, **k: dataclasses.replace(JCFG, name=name))
    monkeypatch.setattr(jsp, "mif_init", lambda rng, c, feat_dim: params)
    monkeypatch.setattr(tsp, "MIF_PRESETS", {v: dataclasses.replace(TCFG, name=v)
                                             for v in ("mif", "mif_st")})
    jctx, tctx = _contexts(seq, muts, None, {"_scorer_name": variant},
                           {"params": model.state_dict()}, structure_dir=tmp_path / "pdb")
    with F32():
        want = jextra.score_mif(jctx)[column].to_numpy()
    got = tscorers.SCORERS[variant](tctx)
    assert list(got) == [column]
    np.testing.assert_allclose(got[column], want, atol=SCORE_ATOL, rtol=0)
    # a state dict file in the model's names, its preset found by blocks and width
    path = tmp_path / "mif.pt"
    torch.save(model.state_dict(), path)
    _, tctx = _contexts(seq, muts, str(path), {}, {}, structure_dir=tmp_path / "pdb")
    np.testing.assert_allclose(tscorers.SCORERS[variant](tctx)[column], want, atol=SCORE_ATOL,
                               rtol=0)
    _, tctx = _contexts(seq, muts, "mif_nonesuch", {}, {}, structure_dir=tmp_path / "pdb")
    with pytest.raises(ValueError, match="not a preset"):
        tscorers.SCORERS[variant](tctx)
