"""The port's ProSST quantizer (proteingym_tpu_torch.models.prosst_quantizer)
against the JAX package's, on a small encoder over a 40-residue helix with
CA noise: the residue graph's features equal, every anchor's subgraph nodes
and edge rows equal, the encoder's embeddings within 1e-5, the pooled and
normalised embeddings and the tokens; the vendored ``AE.pt`` names read by
both loaders, the dims read from them, the seeded JAX init through
``params_from_jax``, the centroid files, and the scorer's
``quantizer_dir=`` path.

The JAX side runs inside ``jax.enable_x64(False)``.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import prosst_quantizer as jq
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import prosst_quantizer as tq
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread", "jitted_encoder")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides through 2 message-passing layers: summation order
# only (the segment sums and index_add_ add the same messages in other
# orders); embeddings of magnitude ~1
EMB_ATOL = 1e-5
SMALL = tq.AutoGraphEncoderConfig(node_h=(16, 4), edge_h=(8, 2), num_layers=2)
JSMALL = jq.AutoGraphEncoderConfig(node_h=(16, 4), edge_h=(8, 2), num_layers=2)


@pytest.fixture
def jitted_encoder(monkeypatch):
    """The JAX encoder under one ``jax.jit`` (op by op it compiles every
    primitive at every shape, which takes seconds on the CPU)."""
    monkeypatch.setattr(jq, "encoder_apply", jax.jit(jq.encoder_apply, static_argnums=1))


def helix(n=40, seed=0, noise=0.3):
    coords = synthetic_helix_backbone(n, seed=seed)
    coords[:, 1] += noise * np.random.RandomState(seed).randn(n, 3)
    return coords


def vendored_state(c=SMALL, seed=0):
    """A random state dict in the vendored AutoGraphEncoder names (numpy)."""
    with torch.device("meta"):
        names = tq.AutoGraphEncoder(c).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in names.items():
        shape = tuple(p.shape)
        if len(shape) == 2:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        elif name.endswith("scalar_norm.weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        sd[name] = v.astype(np.float32)
    return sd


def both(sd, c=SMALL, jc=JSMALL):
    with F32():
        params = jq.convert_torch_state_dict(sd, jc)
    return params, tq.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, c,
                                      device=CPU)


@pytest.mark.parametrize("noise", [0.0, 0.3])
def test_graph_and_subgraphs_equal_jax(noise):
    coords = helix(noise=noise, seed=1)
    want, got = jq.graph_features(coords), tq.graph_features(coords)
    for field in ("node_s", "node_v", "edge_index", "edge_s", "edge_v", "distances"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    assert got.edge_index.shape[1] > 10 * len(coords)
    rows = tq._edge_rows(got)
    for anchor in range(len(coords)):
        a, b = jq.build_subgraph(want, anchor), tq.build_subgraph(got, anchor, edge_rows=rows)
        for key in ("nodes", "edge_index", "edge_feat_rows"):
            np.testing.assert_array_equal(b[key], a[key], err_msg=f"{key} at {anchor}")
    # a dense cloud: more than 30 within 10 A, so the cut to 40 applies
    cloud = np.random.RandomState(2).uniform(0, 6, (60, 4, 3))
    dense = tq.graph_features(cloud)
    for anchor in (0, 17, 59):
        nodes = tq.subgraph_indices(dense.distances, anchor)
        np.testing.assert_array_equal(nodes, jq.subgraph_indices(dense.distances, anchor))
        assert len(nodes) == 40


def _union_jax(graph, anchors):
    """The disjoint union exactly as the JAX ``predict_tokens`` builds it."""
    parts = [[] for _ in range(6)]
    offset = 0
    for anchor in anchors:
        sub = jq.build_subgraph(graph, anchor)
        nodes = sub["nodes"]
        for part, x in zip(parts, (graph.node_s[nodes], graph.node_v[nodes],
                                   graph.edge_s[sub["edge_feat_rows"]],
                                   graph.edge_v[sub["edge_feat_rows"]],
                                   sub["edge_index"][0] + offset, sub["edge_index"][1] + offset)):
            part.append(x)
        offset += len(nodes)
    return [np.concatenate(p) for p in parts]


def test_encoder_embeddings_and_tokens_match_jax():
    params, model = both(vendored_state(seed=3))
    graph = tq.graph_features(helix(seed=4))
    anchors = list(range(40))
    u = tq.union_graph(graph, anchors)
    jax_parts = _union_jax(graph, anchors)
    for got, want in zip([u[k] for k in ("node_s", "node_v", "edge_s", "edge_v", "src", "dst")],
                         jax_parts):
        np.testing.assert_array_equal(got, want)
    with F32():
        want = np.asarray(jq.encoder_apply(params, JSMALL, *map(jnp.asarray, jax_parts)))
    with torch.no_grad():
        got = model(*(torch.as_tensor(u[k]) for k in ("node_s", "node_v", "edge_s", "edge_v",
                                                      "src", "dst"))).numpy()
    assert got.shape == (len(u["node_s"]), 16)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL, rtol=0)
    # the pooled, normalised embeddings and the nearest of 12 centroids
    emb = tq.anchor_embeddings(model, graph).numpy()
    centroids = emb[np.random.RandomState(5).choice(40, 12, replace=False)]
    with F32():
        want_tokens = jq.predict_tokens(params, JSMALL, graph, centroids)
    got_tokens = tq.predict_tokens(model, graph, centroids)
    np.testing.assert_array_equal(got_tokens, want_tokens)
    assert len(set(got_tokens)) > 3
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(tq.structure_tokens_from_coords(helix(seed=4), model,
                                                                  centroids), got_tokens)


def test_loaders_dims_and_seeded_init():
    sd = vendored_state(seed=8)
    assert tq.config_from_state_dict(sd) == SMALL
    assert dataclasses.asdict(jq.config_from_state_dict(sd)) == dataclasses.asdict(SMALL)
    full = vendored_state(tq.AutoGraphEncoderConfig(), seed=9)
    assert tq.config_from_state_dict(full) == tq.AutoGraphEncoderConfig()
    assert "W_out.1.wv.weight" not in full and "layers.5.conv.message_func.2.wv.weight" in full
    with pytest.raises(KeyError, match="W_e.1.wh.weight"):
        tq.load_state_dict({k: v for k, v in sd.items() if k != "W_e.1.wh.weight"}, SMALL,
                           device=CPU)
    with F32():
        params = jax.device_get(jq.init_params(jax.random.PRNGKey(10), JSMALL))
    model = tq.load_state_dict(tq.params_from_jax(params, SMALL), SMALL, device=CPU)
    graph = tq.graph_features(helix(seed=11))
    u = tq.union_graph(graph, range(0, 40, 5))
    args = [u[k] for k in ("node_s", "node_v", "edge_s", "edge_v", "src", "dst")]
    with F32():
        want = np.asarray(jq.encoder_apply(params, JSMALL, *map(jnp.asarray, args)))
    with torch.no_grad():
        got = model(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_allclose(got, want, atol=EMB_ATOL, rtol=0)
    rnd = tq.init_random(tq.AutoGraphEncoderConfig(), seed=0, device=CPU)
    w = rnd.layers[0].conv.message_func[0].ws.weight
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1) < 0.05


def test_read_state_dict_and_centroid_files(tmp_path):
    """AE.pt is read by the port's one checkpoint unwrapper, bare or under
    any of the keys a vendored file may use."""
    from proteingym_tpu_torch.pipeline.checkpoints import _load_torch_state_dict

    sd = {k: torch.from_numpy(v) for k, v in vendored_state(seed=12).items()}
    for i, blob in enumerate((sd, {"state_dict": sd}, {"model": sd, "epoch": 3},
                              {"model_state_dict": sd})):
        torch.save(blob, tmp_path / f"AE{i}.pt")
        got, _ = _load_torch_state_dict(tmp_path / f"AE{i}.pt")
        assert set(got) == set(sd)
        assert tq.config_from_state_dict(got) == tq.config_from_state_dict(sd)
    np.save(tmp_path / "20.npy", np.ones((20, 16), np.float64))
    cents = tq.load_centroids(tmp_path / "20.npy")
    assert cents.dtype == np.float32 and cents.shape == (20, 16)
    with pytest.raises(ValueError, match="save its cluster_centers_"):
        tq.load_centroids(tmp_path / "20.joblib")


def test_scorer_reads_the_quantizer_dir(tmp_path, monkeypatch):
    from proteingym_tpu.models import prosst as jp
    from proteingym_tpu.pipeline import checkpoints as jckpt
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.data.structures import write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_prosst import _contexts, both as prosst_both, hf_state

    seq = "".join(np.random.default_rng(13).choice(list("ACDEFGHIKLMNPQRSTVWY"), 30))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, 30, 4) for a in "GW" if a != seq[p]]
    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", helix(30, seed=14), seq)
    sd = vendored_state(seed=15)
    qparams, model = both(sd)
    qdir = tmp_path / "quantizer"
    qdir.mkdir()
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, qdir / "AE.pt")
    graph = tq.graph_features(helix(30, seed=14))
    emb = tq.anchor_embeddings(model, graph).numpy()
    np.save(qdir / "16.npy", emb[::2][:16])
    psd = hf_state(seed=16)
    pparams, _ = prosst_both(psd)
    monkeypatch.setattr(jp, "prosst_init_params", lambda rng, c: pparams)
    monkeypatch.setattr(jckpt, "restore_pytree", lambda path: qparams)
    monkeypatch.setattr(jq, "AutoGraphEncoderConfig", lambda: JSMALL)
    extra = {"quantizer_dir": str(qdir)}
    jctx, tctx = _contexts(seq, muts, "prosst_tiny", extra,
                           dict(extra, params={k: torch.from_numpy(v) for k, v in psd.items()}),
                           structure_dir=tmp_path / "pdb")
    with F32():
        want = jextra.score_prosst(jctx)["prosst_tiny_score"].to_numpy()
    got = tscorers.SCORERS["prosst"](tctx)["prosst_tiny_score"]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    # the tokens differ from the 3Di states, so the scores move
    del tctx.extra["quantizer_dir"]
    assert not np.allclose(tscorers.SCORERS["prosst"](tctx)["prosst_tiny_score"], got)
    # an orbax directory, and no centroids, raise
    tctx.extra["quantizer_dir"] = str(qdir)
    (qdir / "16.npy").unlink()
    with pytest.raises(FileNotFoundError, match="no centroids"):
        tscorers.SCORERS["prosst"](tctx)
    (qdir / "params").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        tscorers.SCORERS["prosst"](tctx)
