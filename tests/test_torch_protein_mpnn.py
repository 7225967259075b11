"""The port's ProteinMPNN (proteingym_tpu_torch.models.protein_mpnn)
against the JAX package's at the published ``v_48_020`` width (k=48,
hidden 128) on backbones of 40-60 residues, float32 on the CPU:
``featurize`` (neighbours equal, the tie rule on an ideal helix),
``encode``, ``decode`` for one order, ``score_sequences`` with seed 37
(chunked pairs equal one chunk) and the scorer's column read from a
checkpoint file in the reference's layout.

One weight set for both sides: a state dict in the reference's names made
from a seed; the port loads it natively, the JAX side through
``convert_torch_state_dict``, inside ``jax.enable_x64(False)``.
"""

import functools
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import protein_mpnn as jm
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import protein_mpnn as tm
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides, only summation orders differ: edge features and
# hidden states ~1-10 agree to ~1e-6 relative, log-probs and scores
# (~3-5) to ~1e-6
ATOL = 1e-5
SCORE_ATOL = 1e-5
AA = "ACDEFGHIKLMNPQRSTVWY"
CONFIG = tm.PRESETS["v_48_020"]
JCONFIG = jm.MpnnConfig()
jit = functools.partial(jax.jit, static_argnums=1)


def reference_state(seed):
    """A random state dict in the reference's names (numpy), with the
    extra entries a published file may carry."""
    with torch.device("meta"):
        names = tm.ProteinMPNN(CONFIG).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in names.items():
        shape = tuple(p.shape)
        if len(shape) == 2:
            sd[name] = (rng.standard_normal(shape) / np.sqrt(shape[1])).astype(np.float32)
        elif "norm" in name and name.endswith("weight"):
            sd[name] = (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        else:
            sd[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    sd["features.node_embedding.weight"] = np.zeros((128, 6), np.float32)  # unused
    return sd


@pytest.fixture(scope="module")
def world():
    sd = reference_state(seed=1)
    with F32():
        params = jm.convert_torch_state_dict(sd, JCONFIG)
    return types.SimpleNamespace(sd=sd, params=params,
                                 model=tm.load_state_dict(sd, CONFIG, device="cpu"))


def backbone(n, seed, noise=0.05):
    coords = synthetic_helix_backbone(n, seed=seed).astype(np.float32)
    coords += noise * np.random.RandomState(seed).randn(*coords.shape).astype(np.float32)
    return coords


def test_featurize_encode_decode_match_jax(world):
    coords = backbone(48, seed=2)
    rng = np.random.RandomState(2)
    tok = tm.tokenize_sequence("".join(rng.choice(list(AA), 48)))
    order = tm.decoding_orders(48, 1, seed=5)[0]
    with F32():
        je, ji = jit(jm.featurize)(world.params, JCONFIG, jnp.asarray(coords))
        jenc = jit(jm.encode)(world.params, JCONFIG, jnp.asarray(coords))
        jlogp = jit(jm.decode)(world.params, JCONFIG, jenc, jnp.asarray(tok.astype(np.int32)),
                               jnp.asarray(order.astype(np.int32)))
    with torch.no_grad():
        te, ti = tm.featurize(world.model, torch.as_tensor(coords))
    tenc = tm.encode(world.model, torch.as_tensor(coords))
    tlogp = tm.decode(world.model, tenc, torch.as_tensor(tok)[None], torch.as_tensor(order)[None])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=ATOL, rtol=0)
    for got, want in zip(tenc, jenc):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlogp[0].numpy(), np.asarray(jlogp), atol=ATOL, rtol=0)


@pytest.mark.parametrize("k", [30, 48])
def test_ideal_helix_ties_go_to_the_lower_index(k):
    """CA without noise: the neighbours i - d and i + d nearly tie and the
    k-th neighbour falls in such a pair; the port picks JAX's. The JAX
    scorer runs ``featurize`` eagerly (``score_sequences`` calls ``encode``
    outside ``jit``), so that is the side held here: under ``jit`` XLA
    fuses the squared-distance sum and ranks some of these near-ties the
    other way."""
    ideal = synthetic_helix_backbone(120, seed=0).astype(np.float32)
    c = jm.MpnnConfig(k_neighbors=k)
    with F32():
        _, ji = jm.featurize(jm.init_params(jax.random.PRNGKey(0), c), c, jnp.asarray(ideal))
    _, ti = tm.neighbours(torch.as_tensor(ideal[:, 1]), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_score_sequences_matches_jax_and_chunks_change_nothing(world):
    n = 56
    coords = backbone(n, seed=3)
    rng = np.random.RandomState(3)
    seqs = ["".join(rng.choice(list(AA), n)) for _ in range(5)]
    with F32():
        want = jm.score_sequences(world.params, JCONFIG, coords, seqs, n_orders=4, seed=37,
                                  batch_size=3)
    got = tm.score_sequences(world.model, coords, seqs, n_orders=4, seed=37)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    # 20 pairs in one chunk (the budget's rule at this size) and in chunks
    # of 3, which split one sequence's orders across chunks
    assert tm.pairs_per_chunk(world.model, n, 48) >= 20
    chunked = tm.score_sequences(world.model, coords, seqs, n_orders=4, seed=37, max_pairs=3)
    np.testing.assert_allclose(chunked, got, atol=1e-6, rtol=0)


def test_decoding_orders_are_the_jax_scorers_draws():
    rng = np.random.default_rng(37)
    want = np.stack([np.argsort(np.abs(rng.standard_normal(40))) for _ in range(10)])
    np.testing.assert_array_equal(tm.decoding_orders(40, 10), want)


def test_other_lengths_raise(world):
    coords = backbone(40, seed=4)
    with pytest.raises(ValueError, match="structure's length 40"):
        tm.score_sequences(world.model, coords, ["A" * 40, "A" * 41], n_orders=1)


def test_params_from_jax_loader_and_init():
    with F32():
        params = jax.jit(jm.init_params, static_argnums=1)(jax.random.PRNGKey(3), JCONFIG)
    sd = tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), CONFIG)
    model = tm.load_state_dict(sd, CONFIG, device="cpu")
    assert set(model.state_dict()) == set(sd)
    back = jm.convert_torch_state_dict(sd, JCONFIG)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    a, b = (tm.init_random(CONFIG, seed=1, device="cpu") for _ in range(2))
    w = a.decoder_layers[0].W1.weight
    assert torch.equal(w, b.decoder_layers[0].W1.weight)
    lim = np.sqrt(6.0 / (512 + 128))  # Glorot uniform
    assert float(w.abs().max()) <= lim and float(w.abs().max()) > 0.9 * lim
    assert abs(float(a.W_s.weight.std()) - 0.02) < 0.005


def test_scorer_column_from_a_checkpoint_file(world, tmp_path):
    """``protein_mpnn --checkpoint v_48_020.pt`` (``{"model_state_dict":
    ...}``, the published layout) on both scorers."""
    import pandas as pd

    from proteingym_tpu.pipeline import scorers as jscorers
    from proteingym_tpu_torch.data.structures import write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    rng = np.random.RandomState(5)
    n = 44
    seq = "".join(rng.choice(list(AA), n))
    write_pdb_backbone(tmp_path / "P0.pdb", backbone(n, seed=5), seq)
    ckpt = tmp_path / "v_48_020.pt"
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in world.sd.items()},
                "num_edges": 48, "noise_level": 0.2}, ckpt)
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, n, 4) for a in "GW" if a != seq[p]]
    mutated = [seq[:int(m[1:-1]) - 1] + m[-1] + seq[int(m[1:-1]):] for m in muts]
    rec = types.SimpleNamespace(target_seq=seq, UniProt_ID="P0", DMS_id="SYN")
    extra = {"num_seq_per_target": "3"}
    jctx = jscorers.ScoreContext(record=rec, dms_frame=pd.DataFrame(
        {"mutant": muts, "mutated_sequence": mutated}), checkpoint=str(ckpt),
        structure_dir=tmp_path, batch_size=8, extra=extra)
    tctx = tscorers.ScoreContext(record=rec, mutants=muts, mutated_sequences=mutated,
                                 device=CPU, checkpoint=str(ckpt), structure_dir=tmp_path,
                                 batch_size=8, extra=extra)
    with F32():
        want = jscorers.score_protein_mpnn(jctx)["pmpnn_ll"].to_numpy()
    got = tscorers.SCORERS["protein_mpnn"](tctx)
    assert list(got) == ["pmpnn_ll"]
    np.testing.assert_allclose(got["pmpnn_ll"], want, atol=SCORE_ATOL, rtol=0)
    tctx.structure_dir = None
    with pytest.raises(FileNotFoundError, match="needs --structure-dir"):
        tscorers.SCORERS["protein_mpnn"](tctx)
