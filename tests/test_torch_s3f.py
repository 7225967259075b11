"""The port's S2F / S3F (proteingym_tpu_torch.models.s3f) and its plain GVP
(ops/gvp.py) against the JAX package's: the GVP through
``gvp_params_from_jax``; the radius graph and the surface graph's arrays
(equal); the GVP-GNN's node logits, with and without the surface stream,
on one seeded state dict in the published FusionNetwork names under each
prefix the JAX converter probes (the JAX side through
``convert_torch_state_dict_gvpgnn``); the pLDDT swap on both sides of 70;
the GearNet-class surrogate through ``surrogate_params_from_jax`` with
and without the alignment prior; the presets.

The JAX side runs inside ``jax.enable_x64(False)``: float32, as in
production.
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import s3f as js
from proteingym_tpu.ops import gvp as jgvp
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import s3f as ts
from proteingym_tpu_torch.ops import gvp as tgvp
from tests.test_torch_esm3 import _randomize
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides through 2 conv layers per stream: summation order only
ATOL = 1e-5
AA = "ACDEFGHIKLMNPQRSTVWY"
TINY = ts.S3F_PRESETS["s3f_tiny"]
JTINY = js.S3F_PRESETS["s3f_tiny"]


def noisy_helix(n, seed, noise=0.05):
    coords = synthetic_helix_backbone(n, seed=seed)
    coords[:, 1] += noise * np.random.RandomState(seed).randn(n, 3)
    return coords


@pytest.mark.parametrize("vector_gate,activate", [(True, True), (True, False), (False, True)])
def test_gvp_matches_jax(vector_gate, activate):
    with F32():
        p = _randomize(jgvp.gvp_init(jax.random.PRNGKey(1), 6, 3, 8, 4, vector_gate), 1)
    gvp = tgvp.Gvp(6, 3, 8, 4, vector_gate)
    gvp.load_state_dict(tgvp.gvp_params_from_jax(p))
    rs = np.random.RandomState(2)
    s, v = rs.randn(5, 7, 6).astype(np.float32), rs.randn(5, 7, 3, 3).astype(np.float32)
    with F32():
        want_s, want_v = jgvp.gvp_apply(p, jnp.asarray(s), jnp.asarray(v), activate)
    with torch.no_grad():
        got_s, got_v = gvp(torch.from_numpy(s), torch.from_numpy(v), activate)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), atol=ATOL, rtol=0)
    assert (gvp.gate is not None) == vector_gate


def surface_cloud(res_pos, n, n_feat, seed):
    """Seeded points 2-4 A off random residues, with seeded features."""
    rs = np.random.RandomState(seed)
    pos = res_pos[rs.randint(0, len(res_pos), n)] + rs.randn(n, 3) * 1.5
    return pos.astype(np.float32), rs.randn(n, n_feat).astype(np.float32)


def test_graphs_equal_jax():
    pos = noisy_helix(40, 3)[:, 1].astype(np.float32)
    for g, w in zip(ts.radius_graph(pos, 10.0), js.radius_graph(pos, 10.0)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    ideal = synthetic_helix_backbone(40, seed=0)[:, 1].astype(np.float32)
    for g, w in zip(ts.radius_graph(ideal, 6.0), js.radius_graph(ideal, 6.0)):
        np.testing.assert_array_equal(g, w)
    surf_pos, surf_feat = surface_cloud(pos, 120, TINY.surf_in_s, 4)
    got = ts.build_surface_inputs(surf_pos, surf_feat, pos, TINY)
    want = js.build_surface_inputs(surf_pos, surf_feat, pos, JTINY)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    assert got["surf2res"].shape == (120, 3) and len(got["src"]) == 120 * 16


def published_state(c: ts.GvpGnnConfig, seed: int, prefix: str, head: str = "linear"):
    """A seeded state dict in the published names: matrices N(0, 1 / fan_in),
    biases N(0, 0.1^2), layer-norm scales 1 + N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in ts._empty(c, "meta").state_dict().items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        if v.dim() == 2:
            x = x / np.float32(np.sqrt(v.shape[1]))
        elif "norm" in k and k.endswith("weight") or k.endswith("mlp.2.weight"):
            x = np.float32(1) + np.float32(0.1) * x
        else:
            x = np.float32(0.1) * x
        name = (head + k[len("linear"):] if k.startswith("linear.")
                else prefix + k[len("structure_model."):])
        sd[name] = torch.from_numpy(x)
    return sd


def test_node_logits_match_jax():
    sd = published_state(TINY, seed=5, prefix="", head="linear")
    assert ts.state_shape(sd) == ts.config_shape(TINY) == (2, 32, 24, True)
    with F32():
        params = js.convert_torch_state_dict_gvpgnn(sd, JTINY)
        apply = jax.jit(lambda p, *a: js.gvpgnn_node_logits(p, JTINY, *a))
    model = ts.load_state_dict(sd, TINY, device=CPU)
    pos = noisy_helix(30, 6)[:, 1].astype(np.float32)
    src, dst = ts.radius_graph(pos, TINY.radius)
    emb = np.random.RandomState(7).randn(30, TINY.node_in).astype(np.float32)
    surf = ts.build_surface_inputs(*surface_cloud(pos, 90, TINY.surf_in_s, 8), pos, TINY)
    for surface in (None, surf):
        with F32():
            want = np.asarray(apply(params, emb, pos, src, dst, surface))
        got = ts.gvpgnn_node_logits(model, emb, pos, src, dst, surface)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the surface stream adds its global mean to every residue alike
    bare = ts.gvpgnn_node_logits(model, emb, pos, src, dst)
    with torch.no_grad():
        shift = model.structure_model.surface_feature(torch.from_numpy(emb), surf)
    torch.testing.assert_close(got, bare + shift @ model.linear.weight.t(), atol=ATOL, rtol=0)
    # one edge dropped from the aggregation moves the logits (the planted
    # fault of the chip check)
    keep = np.arange(len(src)) != 7
    assert (ts.gvpgnn_node_logits(model, emb, pos, src[keep], dst[keep]) - bare).abs().max() > 1e-3
    # the surface stream's flipped edge vectors are an exact symmetry: every
    # node's vectors start at zero, so all vector channels flip together and
    # the scalars, which see only norms, do not move
    hs = torch.randn(90, TINY.node_in, generator=torch.Generator().manual_seed(9))
    args = [torch.from_numpy(surf["position"])] + [torch.from_numpy(surf[k]).long()
                                                   for k in ("src", "dst")]
    with torch.no_grad():
        flipped = model.structure_model.stream("surf_", hs, *args, flip_edge_vec=True)
        unflipped = model.structure_model.stream("surf_", hs, *args, flip_edge_vec=False)
    assert torch.equal(flipped, unflipped)


@pytest.mark.parametrize("prefix,head", [("model.structure_model.", "linear"),
                                         ("structure_model.", "model.linear"), ("", "task.linear")])
def test_published_prefixes_load_alike(prefix, head):
    want = ts.load_state_dict(published_state(TINY, 5, "", "linear"), TINY, CPU).state_dict()
    sd = published_state(TINY, 5, prefix, head)
    got = ts.load_state_dict(sd, TINY, CPU).state_dict()
    assert ts.state_shape(sd) == ts.config_shape(TINY)
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    if prefix:  # the JAX converter's probe reads bare files only
        with F32(), pytest.raises(KeyError):
            js.convert_torch_state_dict_gvpgnn(sd, JTINY)


def test_plddt_swap_matches_jax():
    rs = np.random.RandomState(9)
    seq = "".join(rs.choice(list(AA), 20))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(20) for a in "GW" if a != seq[p]]
    muts += [f"{seq[0]}1A:{seq[12]}13P", "WT", ""]
    logits = rs.randn(20, 20).astype(np.float32) * 2
    esm20 = rs.randn(20, 20).astype(np.float32) * 3
    plddt = np.where(np.arange(20) % 5 == 0, 50.0, 90.0).astype(np.float32)
    plddt[3] = 70.0  # at the threshold: keeps the structure's logits
    for p in (plddt, None):
        with F32():
            want = js.score_mutants_gvpgnn(logits, esm20, p, seq, muts)
        got = ts.score_mutants_gvpgnn(torch.from_numpy(logits), esm20, p, seq, muts)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    swapped = ts.score_mutants_gvpgnn(logits, esm20, plddt, seq, muts)
    plain = ts.score_mutants_gvpgnn(logits, esm20, None, seq, muts)
    low = [i for i, m in enumerate(muts[:-3]) if int(m[1:-1]) % 5 == 1]
    high = [i for i, m in enumerate(muts[:-3]) if int(m[1:-1]) % 5 != 1]
    assert not np.allclose(swapped[low], plain[low]) and np.allclose(swapped[high], plain[high])
    assert swapped[-1] == swapped[-2] == 0.0


def test_presets_and_seeded_init():
    assert {k: dataclasses.asdict(v) for k, v in ts.S3F_PRESETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in js.S3F_PRESETS.items()}
    assert ts.TD_RESIDUES == js.TD_RESIDUES
    model = ts.init_random(dataclasses.replace(ts.S3F_PRESETS["s3f"], num_layers=1), seed=0,
                           device=CPU)
    w = model.structure_model.residue_embdding.weight
    assert w.shape == (1280, 1280) and abs(float(w.std()) * np.sqrt(1280) - 1) < 0.02
    assert float(model.structure_model.surf_in_mlp[2].weight.min()) == 1.0
    assert not model.linear.bias.any()


@pytest.mark.parametrize("use_surface", [True, False])
def test_surrogate_matches_jax(use_surface):
    jc = js.S3fConfig(plm_dim=16, hidden_dim=16, num_layers=2, k_neighbors=6,
                      use_surface=use_surface)
    tc = ts.S3fConfig(plm_dim=16, hidden_dim=16, num_layers=2, k_neighbors=6,
                      use_surface=use_surface)
    with F32():
        params = _randomize(js.init_params(jax.random.PRNGKey(3), jc), 3)
    model = ts.surrogate_load_state_dict(ts.surrogate_params_from_jax(params), tc, device=CPU)
    rs = np.random.RandomState(4)
    seq = "".join(rs.choice(list(AA), 24))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, 24, 2) for a in "DW" if a != seq[p]]
    muts += [f"{seq[2]}3A:{seq[9]}10G", "WT"]
    emb = rs.randn(24, 16).astype(np.float32)
    coords = noisy_helix(24, 5)
    msa = ["".join(rs.choice(list(AA + "-"), 24)) for _ in range(7)]
    for rows in (None, msa):
        with F32():
            want = js.score_mutants(params, jc, emb, coords, seq, muts, msa_sequences=rows)
        got = ts.score_mutants(model, emb, coords, seq, muts, msa_sequences=rows)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
        assert got[-1] == 0.0
    # a protein shorter than k + 1: the spatial relation is padded, not double counted
    short = ts.logits(model, torch.from_numpy(emb[:5]),
                      torch.as_tensor(coords[:5, 1], dtype=torch.float32))
    with F32():
        want = np.asarray(js.logits(params, jc, jnp.asarray(emb[:5]),
                                    jnp.asarray(coords[:5, 1], jnp.float32)))
    np.testing.assert_allclose(short.numpy(), want, atol=ATOL, rtol=0)
    seeded = ts.init_params(tc, seed=0, device=CPU)
    assert seeded.layers[0].rel_w.shape == (5, 16, 16) and not seeded.head.bias.any()
