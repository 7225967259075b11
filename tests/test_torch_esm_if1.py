"""The port's ESM-IF1 (proteingym_tpu_torch.models.gvp_transformer) against
the JAX package's, at ``esm_if1_tiny`` in float32 on the CPU: the kNN
(indices equal, the tie rule on an ideal helix), the node and edge
features, the GVP encoder, the encoder output, the decoder's logits,
``score_sequences`` (an indel row as long as the encoder routed as JAX
routes it), the multichain path and the scorer's column.

One weight set for both sides: a state dict in fair-esm's layout (with the
``_float_tensor`` buffers a published file carries), made from a seed; the
port reads it with its own loader, the JAX side through
``convert_torch_state_dict``. The JAX side runs inside
``jax.enable_x64(False)`` (the harness turns x64 on); CPU tensors take the
plain attention.
"""

import functools
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import gvp_transformer as jg
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import gvp_transformer as tg
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides, only summation orders differ: features and
# activations of magnitude ~1-10 agree to ~1e-6 relative
ATOL = 1e-5
SCORE_ATOL = 1e-5
AA = "ACDEFGHIKLMNPQRSTVWY"
TINY = tg.PRESETS["esm_if1_tiny"]
JTINY = jg.PRESETS["esm_if1_tiny"]
# the JAX functions jitted (eager dispatch of their many small ops is slow)
jit = functools.partial(jax.jit, static_argnums=1)


def fair_esm_state(config, seed):
    """A random state dict in fair-esm's names (numpy), with the
    ``_float_tensor`` buffers of a published file."""
    with torch.device("meta"):
        names = tg.GVPTransformerModel(config).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in names.items():
        shape = tuple(p.shape)
        if len(shape) == 2:
            sd[name] = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        elif name.endswith(("norm.weight", "norm_nodes.gain", "layer_norm.weight")):
            sd[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    for side in ("encoder", "decoder"):
        sd[f"{side}.embed_positions._float_tensor"] = np.zeros(1, np.float32)
    return sd


@pytest.fixture(scope="module")
def world():
    sd = fair_esm_state(TINY, seed=3)
    with F32():
        params = jg.convert_torch_state_dict(sd, JTINY)
    model = tg.load_state_dict(sd, TINY, device="cpu")
    return types.SimpleNamespace(sd=sd, params=params, model=model)


def noisy_backbone(n, seed, noise=0.05):
    """A helix with seeded noise on CA too (no tied distances)."""
    coords = synthetic_helix_backbone(n, seed=seed)[:, :3].astype(np.float32)
    coords[:, 1] += noise * np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return coords


def batch(coords):
    """The encoder's inputs of a structure, as numpy: cleaned coords, coord
    mask, padding, confidence, with a batch axis."""
    pc, conf, padding = tg.prepare_structure(coords)
    mask = np.isfinite(pc).all(-1).all(-1)
    return (np.where(np.isfinite(pc), pc, 0.0)[None], mask[None], padding[None], conf[None],
            pc[None])


def t(x):
    return torch.as_tensor(np.asarray(x))


def spaced(coords, gap=(8, 14)):
    """``coords`` with residues gap[0]:gap[1] NaN (a multichain spacer:
    encoder padding)."""
    out = coords.copy()
    out[gap[0]:gap[1]] = np.nan
    return out


@pytest.mark.parametrize("case", ["helix", "spacer"])
def test_knn_and_features_match_jax(world, case):
    coords = noisy_backbone(36, seed=1)
    if case == "spacer":
        coords = spaced(coords)
    x, mask, padding, conf, _ = batch(coords)
    with F32():
        jd, ji, jcm, jrm = jax.jit(jg._dist, static_argnums=3)(
            jnp.asarray(x[:, :, 1]), jnp.asarray(mask), jnp.asarray(padding),
            JTINY.gvp_top_k_neighbors)
        js, jv = jax.jit(jg.get_node_features)(jnp.asarray(x), jnp.asarray(mask))
        (jes, jev), (jsrc, jdst), jvalid = jax.jit(jg.get_edge_features, static_argnums=3)(
            jnp.asarray(x), jnp.asarray(mask), jnp.asarray(padding), JTINY.gvp_top_k_neighbors)
    td, ti, tcm, trm = tg.knn(t(x[:, :, 1]), t(mask), t(padding), TINY.gvp_top_k_neighbors)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
    np.testing.assert_array_equal(trm.numpy(), np.asarray(jrm))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=0)
    ts, tv = tg.get_node_features(t(x), t(mask))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    (tes, tev), (tsrc, tdst), tvalid = tg.get_edge_features(
        t(x), t(mask), t(padding), TINY.gvp_top_k_neighbors)
    np.testing.assert_array_equal(tdst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(tsrc.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tes.numpy(), np.asarray(jes), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [30, 48])
def test_ideal_helix_ties_go_to_the_lower_index(k):
    """CA without noise: residue i's neighbours i - d and i + d sit at
    (nearly) tied distances, and the k-th neighbour falls in such a pair;
    the port picks JAX's."""
    ca = synthetic_helix_backbone(120, seed=0)[:, 1].astype(np.float32)[None]
    mask = np.ones((1, 120), bool)
    with F32():
        _, ji, _, _ = jg._dist(jnp.asarray(ca), jnp.asarray(mask), jnp.asarray(~mask), k)
    _, ti, _, _ = tg.knn(t(ca), t(mask), t(~mask), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_gvp_encoder_and_encoder_match_jax(world):
    x, mask, padding, conf, raw = batch(spaced(noisy_backbone(40, seed=2)))
    with F32():
        js, jv = jit(jg.gvp_encoder_apply)(world.params, JTINY, jnp.asarray(x),
                                           jnp.asarray(mask), jnp.asarray(padding),
                                           jnp.asarray(conf))
        jenc = jit(jg.encoder_apply)(world.params, JTINY, jnp.asarray(raw),
                                     jnp.asarray(padding), jnp.asarray(conf))
    with torch.no_grad():
        ts, tv = world.model.encoder.gvp_encoder(t(x), t(mask), t(padding), t(conf))
        tenc = world.model.encoder(t(raw), t(padding), t(conf))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), atol=ATOL, rtol=0)


def _tokens(seqs):
    rows = [tg.tokenize(s) for s in seqs]
    tok = np.full((len(rows), max(len(r) for r in rows)), tg.PAD_IDX, np.int64)
    for i, r in enumerate(rows):
        tok[i, :len(r)] = r
    return tok


def test_decoder_logits_match_jax(world):
    coords = noisy_backbone(30, seed=4)
    _, _, padding, conf, raw = batch(coords)
    rng = np.random.RandomState(4)
    tok = _tokens(["".join(rng.choice(list(AA), n)) for n in (30, 27, 30)])[:, :-1]
    with F32():
        enc = jit(jg.encoder_apply)(world.params, JTINY, jnp.asarray(raw),
                                    jnp.asarray(padding), jnp.asarray(conf))
        want = jit(jg.decoder_apply)(world.params, JTINY, jnp.asarray(tok.astype(np.int32)),
                                jnp.broadcast_to(enc, (3,) + enc.shape[1:]),
                                jnp.broadcast_to(jnp.asarray(padding), (3, padding.shape[1])))
    with torch.no_grad():
        tenc = world.model.encoder(t(raw), t(padding), t(conf))
        got = world.model.decoder(t(tok), tenc, t(padding))
    live = tok != tg.PAD_IDX
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], atol=ATOL, rtol=0)


def test_score_sequences_matches_jax_and_routes_as_jax(world, monkeypatch):
    """Substitution rows, a shorter one and an indel row as long as the
    encoder's L + 2: its batch's cross attention has Tq == Tk and goes
    through ``mha`` (not causal), as the JAX dispatch sends it."""
    n = 32
    coords = noisy_backbone(n, seed=5)
    rng = np.random.RandomState(5)
    seqs = ["".join(rng.choice(list(AA), m)) for m in (n, n, n - 3, n + 2, n, n)]
    with F32():
        want = jg.score_sequences(world.params, JTINY, coords, seqs, batch_size=4)
    calls = []
    real = tg.mha

    def spy(q, k, v, key_mask=None, causal=False, sm_scale=None):
        calls.append((q.shape[2], causal))
        return real(q, k, v, key_mask=key_mask, causal=causal, sm_scale=sm_scale)

    monkeypatch.setattr(tg, "mha", spy)
    got = tg.score_sequences(world.model, coords, seqs, batch_size=4)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    # every row is PAD-filled to n + 3 tokens, so the decoder runs n + 2
    # queries against the encoder's n + 2 keys: self and cross through mha
    t_enc = n + 2
    enc = [(t_enc, False)] * TINY.encoder_layers
    dec = [(t_enc, True), (t_enc, False)] * TINY.decoder_layers
    assert calls == enc + dec + dec
    # substitutions alone: cross attention is plain (Tq = n != n + 2)
    calls.clear()
    tg.score_sequences(world.model, coords, seqs[:2], batch_size=4)
    assert calls == enc + [(n, True)] * TINY.decoder_layers


def test_complex_path_matches_jax(world):
    chains = {"B": noisy_backbone(18, seed=7), "A": noisy_backbone(24, seed=6)}
    rng = np.random.RandomState(6)
    seqs = ["".join(rng.choice(list(AA), 24)) for _ in range(3)]
    with F32():
        want = jg.score_sequences_in_complex(world.params, JTINY, chains, "A", seqs, batch_size=2)
        jall = jg.concatenate_complex_coords(chains, "A")
    tall = tg.concatenate_complex_coords(chains, "A")
    np.testing.assert_array_equal(tall, jall)
    got = tg.score_sequences_in_complex(world.model, chains, "A", seqs, batch_size=2)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    _, _, padding = tg.prepare_structure(tall)
    assert padding.sum() == 10 and not padding[[0, -1]].any()  # the spacer, not the flanks


def test_params_from_jax_and_the_loader(world):
    with F32():
        params = jax.jit(jg.init_params, static_argnums=1)(jax.random.PRNGKey(2), JTINY)
    sd = tg.params_from_jax(jax.tree_util.tree_map(np.asarray, params), TINY)
    model = tg.load_state_dict(sd, TINY, device="cpu")
    assert set(model.state_dict()) == set(sd)
    back = jg.convert_torch_state_dict({k: v.numpy() for k, v in sd.items()}, JTINY)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    missing = dict(world.sd)
    del missing["decoder.output_projection.weight"]
    with pytest.raises(KeyError, match="output_projection"):
        tg.load_state_dict(missing, TINY, device="cpu")


def test_random_init_is_seeded_and_float32():
    a, b = (tg.init_random(TINY, seed=4, device="cpu") for _ in range(2))
    c = tg.init_random(TINY, seed=5, device="cpu")
    for (name, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                               c.state_dict().values()):
        assert x.dtype == torch.float32 and torch.equal(x, y), name
    w = a.state_dict()["decoder.layers.0.fc1.weight"]
    assert not torch.equal(w, c.state_dict()["decoder.layers.0.fc1.weight"])
    assert abs(float(w.std()) - TINY.decoder_embed_dim ** -0.5) < 0.02
    assert float(a.state_dict()["decoder.layers.0.fc1.bias"].abs().max()) == 0.0


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.init_random(TINY)


def write_complex_pdb(path, chains):
    """One PDB of several chains ({chain id: ((L, 4, 3) coords, sequence)})."""
    from proteingym_tpu_torch.data.structures import write_pdb_backbone

    text = ""
    for ch, (coords, seq) in chains.items():
        write_pdb_backbone(path, coords, seq, chain=ch)
        text += path.read_text().replace("END\n", "")
    path.write_text(text + "END\n")


@pytest.mark.parametrize("complex_", [False, True], ids=["single", "complex"])
def test_scorer_column_matches_jax(world, tmp_path, monkeypatch, complex_):
    """The ``esm_if1`` scorers on one assay and one weight set (the JAX init
    patched to return it; the port given it as ``extra["params"]``): one
    chain, and ``complex_chains=A,B`` with ``target_chain=A``."""
    import pandas as pd

    from proteingym_tpu.pipeline import scorers as jscorers
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    rng = np.random.RandomState(8)
    seq = "".join(rng.choice(list(AA), 26))
    backbone = synthetic_helix_backbone(26, seed=8)
    backbone[:, 1] += 0.05 * rng.randn(26, 3)
    chains = {"A": (backbone, seq)}
    if complex_:
        other = synthetic_helix_backbone(15, seed=9) + np.array([12.0, 0.0, 0.0])
        chains["B"] = (other, "".join(rng.choice(list(AA), 15)))
    write_complex_pdb(tmp_path / "P0.pdb", chains)
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, 26, 3) for a in "AW" if a != seq[p]]
    mutated = [seq[:int(m[1:-1]) - 1] + m[-1] + seq[int(m[1:-1]):] for m in muts]
    extra = {"complex_chains": "A,B", "target_chain": "A"} if complex_ else {}
    monkeypatch.setattr(jg, "init_params", lambda rng, c: world.params)
    rec = types.SimpleNamespace(target_seq=seq, UniProt_ID="P0", DMS_id="SYN")
    jctx = jscorers.ScoreContext(record=rec, dms_frame=pd.DataFrame(
        {"mutant": muts, "mutated_sequence": mutated}), checkpoint="esm_if1_tiny",
        structure_dir=tmp_path, batch_size=4, extra=extra)
    tctx = tscorers.ScoreContext(
        record=rec, mutants=muts, mutated_sequences=mutated, device=CPU,
        checkpoint="esm_if1_tiny", structure_dir=tmp_path, batch_size=4,
        extra=dict(extra, params={k: torch.from_numpy(v) for k, v in world.sd.items()}))
    with F32():
        want = jextra.score_esm_if1(jctx)["esm_if1_score"].to_numpy()
    got = tscorers.SCORERS["esm_if1"](tctx)
    assert list(got) == ["esm_if1_score"]
    np.testing.assert_allclose(got["esm_if1_score"], want, atol=SCORE_ATOL, rtol=0)



def test_unknown_checkpoint_names_raise():
    """A name that is neither a preset nor a file raises (a published file
    resolves to its preset by shape: tests/test_torch_cli.py)."""
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    rec = types.SimpleNamespace(target_seq="AC", UniProt_ID="P0", DMS_id="SYN")
    for model, name in (("esm_if1", "ESM-IF1"), ("protein_mpnn", "ProteinMPNN")):
        ctx = tscorers.ScoreContext(record=rec, mutants=[], device=CPU, checkpoint="huge",
                                    structure_dir=".")
        with pytest.raises(ValueError, match=f"Unknown {name} checkpoint"):
            tscorers.SCORERS[model](ctx)
