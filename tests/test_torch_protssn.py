"""The port's ProtSSN (proteingym_tpu_torch.models.protssn) and its EGNN
(ops/gnn.py) against the JAX package's: the k-NN EGNN through
``egnn_params_from_jax`` (with and without the coordinate update), the
CA graph and its 93 edge features (equal, on a noisy helix and on the
ideal helix whose CA distances tie in pairs), the statistics'
normalisation, the weight-compatible stack's log-probs and scores on one
seeded state dict in the published names (the JAX side through
``convert_torch_state_dict``), the surrogate through ``params_from_jax``,
and the presets, file-name k and shape inference.

The JAX side runs inside ``jax.enable_x64(False)``: float32, as in
production.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import protssn as jp
from proteingym_tpu.ops import gnn as jgnn
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import protssn as tp
from proteingym_tpu_torch.ops import gnn as tgnn
from tests.test_torch_esm3 import _randomize
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides through 2-3 layers: summation order only, held
# relative to the largest magnitude (the EGNN's features grow to ~1e2)
ATOL = 1e-5
AA = "ACDEFGHIKLMNPQRSTVWY"
TINY = dict(name="protssn_k10_h16", input_dim=24, m_dim=16, n_layers=2, k_neighbors=10)


def close(got, want, atol=ATOL):
    want = np.asarray(want)
    assert np.abs(np.asarray(got) - want).max() <= atol * max(1.0, np.abs(want).max())


def noisy_helix(n, seed, noise=0.05):
    coords = synthetic_helix_backbone(n, seed=seed)
    coords[:, 1] += noise * np.random.RandomState(seed).randn(n, 3)
    return coords


@pytest.mark.parametrize("update_coords", [False, True])
def test_egnn_matches_jax(update_coords):
    c = dict(node_dim=12, hidden_dim=16, num_layers=2, k_neighbors=6,
             update_coords=update_coords, out_dim=20)
    with F32():
        params = _randomize(jgnn.egnn_init(jax.random.PRNGKey(3), jgnn.EgnnConfig(**c)), 3)
    model = tgnn.egnn_load_state_dict(tgnn.egnn_params_from_jax(params), tgnn.EgnnConfig(**c),
                                      device=CPU)
    rs = np.random.RandomState(4)
    feats, coords = rs.randn(20, 12).astype(np.float32), 3 * rs.randn(20, 3).astype(np.float32)
    with F32():  # under one jit: op by op the JAX EGNN takes seconds
        jc = jgnn.EgnnConfig(**c)
        want_h, want_x = jax.jit(jgnn.egnn_apply, static_argnums=1)(params, jc, feats, coords)
        want_out = np.asarray(jax.jit(jgnn.egnn_readout, static_argnums=1)(params, jc, want_h))
    with torch.no_grad():
        h, x = model(torch.from_numpy(feats), torch.from_numpy(coords))
        out = model.readout(h)
    close(h.numpy(), want_h)
    close(x.numpy(), want_x)
    close(out.numpy(), want_out)
    assert update_coords == (not np.array_equal(x.numpy(), coords))


@pytest.mark.parametrize("coords,k", [("noisy", 10), ("noisy", 30), ("ideal", 20), ("short", 10)])
def test_calpha_graph_equals_jax(coords, k):
    n = 9 if coords == "short" else 45
    bb = synthetic_helix_backbone(n, seed=0) if coords == "ideal" else noisy_helix(n, 2)
    cutoff = 5.0 if coords == "short" else 30.0  # a short cutoff leaves some with one neighbour
    got = tp.build_calpha_graph(bb[:, :3], k, cutoff)
    want = jp.build_calpha_graph(bb[:, :3], k, cutoff)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    src, dst, edge_attr, pos = got
    assert edge_attr.shape == (len(src), 93) and pos.shape == (n, 3)
    if coords == "ideal":  # i - j and i + j tie on the ideal helix
        ca = bb[:, 1]
        d = np.linalg.norm(ca[20] - ca, axis=-1)
        assert np.isclose(d[19], d[21], rtol=1e-9)


def _stats(seed):
    rs = np.random.RandomState(seed)
    return {"pos_std": rs.uniform(5, 15, 3).astype(np.float32),
            "edge_attr_mean": rs.randn(93).astype(np.float32),
            "edge_attr_std": rs.uniform(0.5, 2, 93).astype(np.float32)}


def test_norm_stats_equal_jax(tmp_path):
    src, dst, edge_attr, pos = tp.build_calpha_graph(noisy_helix(30, 3)[:, :3], 10)
    stats = _stats(1)
    torch.save({k: torch.from_numpy(v) for k, v in stats.items()}, tmp_path / "cath_k10.pt")
    loaded = tp.load_norm_stats(tmp_path / "cath_k10.pt")
    for k in stats:
        np.testing.assert_array_equal(loaded[k], jp.load_norm_stats(tmp_path / "cath_k10.pt")[k])
    for s in (loaded, tp.identity_norm_stats()):
        got = tp.apply_norm_stats(pos, edge_attr, s)
        want = jp.apply_norm_stats(pos, edge_attr, s)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    # the skip boundary cuts into the one-hot: its last column is standardised
    npos, nea = tp.apply_norm_stats(pos, edge_attr, loaded)
    np.testing.assert_array_equal(nea[:, :64], edge_attr[:, :64])
    assert not np.array_equal(nea[:, 64], edge_attr[:, 64])


def published_state(c: tp.ProtssnEgnnConfig, seed: int, prefix="GNN_model."):
    """A seeded state dict in the published names: matrices N(0, 1 / fan_in),
    biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in tp._empty(c, "meta").state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        x = rng.standard_normal(shape).astype(np.float32)
        x = x / np.float32(np.sqrt(shape[1])) if len(shape) == 2 else np.float32(0.1) * x
        sd[prefix + k] = torch.from_numpy(x)
    return sd


def _assay(length, seed):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), length))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, length, 3) for a in "AW" if a != seq[p]]
    return seq, muts + [f"{seq[1]}2K:{seq[6]}7P", f"{seq[2]}3G;{seq[4]}5W", "WT"]


def test_published_stack_matches_jax():
    c = tp.ProtssnEgnnConfig(**TINY)
    sd = published_state(c, seed=7)
    with F32():
        jcfg = jp.config_from_state_dict(sd, jp.ProtssnEgnnConfig(**TINY))
        params = jp.convert_torch_state_dict(sd, jcfg)
    model = tp.load_state_dict(sd, tp.config_from_state_dict(sd, tp.ProtssnEgnnConfig()), "cpu")
    seq, muts = _assay(36, 8)
    bb = noisy_helix(36, 9)
    src, dst, edge_attr, pos = tp.build_calpha_graph(bb[:, :3], c.k_neighbors)
    npos, nea = tp.apply_norm_stats(pos, edge_attr, _stats(2))
    emb = np.random.RandomState(10).randn(36, c.input_dim).astype(np.float32)
    with F32():
        want = np.asarray(jp.egnn_log_probs(params, jcfg, emb, npos, src, dst, nea))
        want_scores = jp.score_mutants_egnn(want, seq, muts)
    got = tp.egnn_log_probs(model, emb, npos, src, dst, nea)
    close(got.numpy(), want)
    got_scores = tp.score_mutants_egnn(got, seq, muts)
    close(got_scores, want_scores)
    assert got_scores[-1] == 0.0 and len(set(got_scores)) > len(muts) // 2
    # the aggregation at dst moves the result: one edge dropped is seen
    keep = np.arange(len(src)) != 5
    dropped = tp.egnn_log_probs(model, emb, npos, src[keep], dst[keep], nea[keep])
    assert (dropped - got).abs().max() > 1e-3
    with pytest.raises(ValueError, match="WT mismatch"):
        tp.score_mutants_egnn(got, seq, [f"{'A' if seq[0] != 'A' else 'C'}1W"])
    # params_from_jax is the inverse of the JAX converter
    back = tp.params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    for k, v in back.items():
        torch.testing.assert_close(v, sd["GNN_model." + k], rtol=0, atol=0)


def test_config_from_shapes_and_file_names(tmp_path):
    c = tp.ProtssnEgnnConfig(**TINY)
    sd = published_state(c, seed=1, prefix="")
    got = tp.config_from_state_dict(sd, tp.ProtssnEgnnConfig())
    want = jp.config_from_state_dict(sd, jp.ProtssnEgnnConfig())
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.n_layers, got.m_dim, got.input_dim, got.k_neighbors) == (2, 16, 24, 20)
    assert tp.base_config_for_file(tmp_path / "protssn_k30_h768.pt") == \
        tp.PROTSSN_PRESETS["protssn_k30_h768"]
    assert tp.base_config_for_file("x/protssn_k10_h16.pt").k_neighbors == 10
    assert tp.base_config_for_file("x/weights.pt") == tp.ProtssnEgnnConfig()
    assert {k: dataclasses.asdict(v) for k, v in tp.PROTSSN_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in jp.PROTSSN_PRESETS.items()}
    assert len(tp.PROTSSN_PRESETS) == 9
    model = tp.init_random(dataclasses.replace(c, n_layers=1), seed=0, device=CPU)
    w = model.mpnn_layes[0].edge_mlp[0].weight
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1) < 0.05
    assert not model.lin.bias.any()


def test_surrogate_matches_jax():
    jc = jp.ProtssnConfig(node_dim=16, hidden_dim=16, num_layers=2, k_neighbors=6)
    tc = tp.ProtssnConfig(node_dim=16, hidden_dim=16, num_layers=2, k_neighbors=6)
    with F32():
        params = _randomize(jp.init_params(jax.random.PRNGKey(2), jc), 2)
    model = tgnn.egnn_load_state_dict(tgnn.egnn_params_from_jax(params), tc.egnn(), device=CPU)
    seq, muts = _assay(28, 3)
    muts = muts[:-2]  # the surrogate reads ':' only, and no WT rows
    emb = np.random.RandomState(4).randn(28, 16).astype(np.float32)
    ca = noisy_helix(28, 5)[:, 1].astype(np.float32)
    with F32():
        want = np.asarray(jp.logits(params, jc, jnp.asarray(emb), jnp.asarray(ca)))
        want_scores = jp.score_mutants(params, jc, jnp.asarray(emb), jnp.asarray(ca), seq, muts)
    t = lambda x: torch.from_numpy(x)  # noqa: E731
    close(tp.logits(model, tc, t(emb), t(ca)).numpy(), want)
    close(tp.score_mutants(model, tc, t(emb), t(ca), seq, muts), want_scores)
    seeded = tp.init_params(tc, seed=0, device=CPU)
    assert seeded.head is not None and not seeded.layers[0].edge_mlp[0].bias.any()
