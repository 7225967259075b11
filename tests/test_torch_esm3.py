"""The port's ESM3 (proteingym_tpu_torch.models.esm3) against the JAX
package's, on the tiny configs, everything float32: the frames (NaN and
>= 1e6 coordinates, a batch row without any), geometric attention alone,
the input encoder with the function and residue bags, ``forward`` with
and without coordinates, the kNN neighbourhoods (as sets on noisy
coordinates; the tie rule where no residue has coordinates), the
structure tokens on noisy coordinates, ``score_assay_esm3`` sequence-only
and structure-conditioned, and the distance term against the 5-D
difference form.

One weight set for both sides: the JAX init, made random in every leaf
(layer-norm scales and biases, geometric scales), written in the SDK's
layout and read by each side's own loader. The JAX side runs inside
``jax.enable_x64(False)`` (the harness turns x64 on, which makes its
``linspace`` and ``eye`` float64); CPU tensors take the plain attention.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esm3 as j3
from proteingym_tpu_torch.models import esm3 as t3
from tests.test_torch_esmc import CPU, F32
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

# float32 on both sides; only summation orders differ (~1e-6 relative on
# values of magnitude ~1-10)
ATOL = 1e-4
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
TINY_SC = j3.STRUCTURE_ENCODER_PRESETS["esm3_structure_encoder_tiny"]
# a mid-size encoder: the full encoder's head width, fewer channels
MID_SC = j3.StructureEncoderConfig(name="mid", d_model=128, v_heads=128, n_layers=2,
                                   d_out=32, n_codes=512, knn=16)


def make_coords(n, seed=11):
    """A random walk of CA atoms with noise on every atom (no exact ties
    between distances), as tests/test_esm3_parity.py builds them."""
    rng = np.random.RandomState(seed)
    ca = np.cumsum(rng.randn(n, 3) * 1.1 + np.array([3.5, 0.4, 0.1]), axis=0)
    nn_ = ca + rng.randn(n, 3) * 0.3 + np.array([-1.2, 0.4, 0.0])
    c = ca + rng.randn(n, 3) * 0.3 + np.array([1.2, -0.4, 0.0])
    return np.stack([nn_, ca, c], axis=1).astype(np.float32)


def _randomize(tree, seed, unit_matrices=False):
    """Every float leaf moved off its init: scales 1 + N(0, 0.1^2), zeros
    N(0, 0.1^2), other leaves plus 10% noise; with ``unit_matrices`` every
    matrix N(0, 1 / rows) instead (the encoder's init is so small that
    every residue's query node, and so its code, is the same)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    out = []
    for x in leaves:
        x = np.asarray(x, np.float32)
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if unit_matrices and x.ndim == 2:
            x = noise / np.sqrt(x.shape[0])
        elif not x.any():
            x = 0.1 * noise
        elif np.all(x == 1):
            x = 1 + 0.1 * noise
        else:
            x = x * (1 + 0.1 * noise)
        out.append(x)
    return jax.tree_util.tree_unflatten(treedef, out)


def _heads_sd(params):
    """The five output heads scoring does not read, in the SDK layout (the
    JAX converter reads all six)."""
    sd = {}
    for name in ("structure", "ss8", "sasa", "function", "residue"):
        p, prefix = params["heads"][name], f"output_heads.{name}_head"
        for idx, key in (("0", "dense"), ("3", "out")):
            sd[f"{prefix}.{idx}.weight"] = np.asarray(p[key]["w"]).T
            sd[f"{prefix}.{idx}.bias"] = np.asarray(p[key]["b"])
        sd[f"{prefix}.2.weight"], sd[f"{prefix}.2.bias"] = p["ln"]["g"], p["ln"]["b"]
    return sd


def esm3_pair(seed=0, c=j3.TINY):
    with F32():
        host = _randomize(j3.init_params(jax.random.PRNGKey(seed), c), seed)
        sd = {**{k: v.numpy() for k, v in t3.params_from_jax(host, c).items()}, **_heads_sd(host)}
        params = j3.convert_torch_state_dict(sd, c)
    return params, t3.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                                      c, device=CPU)


def encoder_pair(sc, seed=0):
    with F32():
        host = _randomize(j3.structure_encoder_init(jax.random.PRNGKey(seed), sc), seed + 1,
                          unit_matrices=True)
        sd = {k: v.numpy() for k, v in t3.structure_encoder_params_from_jax(host, sc).items()}
        params = j3.convert_structure_encoder_state_dict(sd, sc)
    return params, t3.load_structure_encoder_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, sc, device=CPU)


@pytest.fixture(scope="module")
def pair():
    return esm3_pair(0)


def _broken_coords():
    """(2, 7, 3, 3): row 0 with a NaN residue, a residue at 1e6 and one at
    -inf; row 1 with no coordinates at all."""
    x = np.stack([make_coords(7, 1), make_coords(7, 2)])
    x[0, 2, 1, 0] = np.nan
    x[0, 4, 0, 2] = 1e6
    x[0, 5, 2, 1] = -np.inf
    x[1] = np.nan
    return x


def test_frames_match_jax():
    x = _broken_coords()
    with F32():
        want = [np.asarray(a) for a in j3.build_affine_from_coordinates(jnp.asarray(x))]
    got = [a.numpy() for a in t3.build_affine_from_coordinates(torch.from_numpy(x))]
    np.testing.assert_array_equal(got[2], want[2])
    assert got[2][0].tolist() == [True, True, False, True, False, False, True]
    assert not got[2][1].any()
    np.testing.assert_allclose(got[0], want[0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(got[0][1], np.broadcast_to(np.eye(3), (7, 3, 3)))


@pytest.mark.parametrize("zero_frameless", [True, False])
def test_geometric_attention_matches_jax(pair, zero_frameless):
    params, model = pair
    x = np.random.RandomState(3).randn(2, 7, j3.TINY.d_model).astype(np.float32)
    coords = _broken_coords()
    with F32():
        R, t, m = j3.build_affine_from_coordinates(jnp.asarray(coords))
        want = np.asarray(j3.geom_attn_apply(params["layers"][0]["geom"], jnp.asarray(x), R, t, m,
                                             j3.TINY.v_heads,
                                             mask_and_zero_frameless=zero_frameless))
    R, t, m = t3.build_affine_from_coordinates(torch.from_numpy(coords))
    with torch.no_grad():
        got = model.transformer.blocks[0].geom_attn(torch.from_numpy(x), R, t, m,
                                                    zero_frameless).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_distance_term_equals_the_5d_form():
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(2, 9, 5, 3).astype(np.float32) * 30 + 200)
    k = torch.from_numpy(rng.randn(2, 9, 5, 3).astype(np.float32) * 30 + 200)
    direct = torch.linalg.norm(q[:, :, None] - k[:, None, :], dim=-1).permute(0, 3, 1, 2)
    torch.testing.assert_close(t3.distance_term(q, k), direct, atol=1e-4, rtol=1e-6)


def test_encode_inputs_match_jax(pair):
    params, model = pair
    rng = np.random.RandomState(5)
    b, n = 2, 9
    args = dict(
        sequence_tokens=rng.randint(0, 64, (b, n)), structure_tokens=rng.randint(0, 4101, (b, n)),
        average_plddt=rng.rand(b, n).astype(np.float32),
        per_res_plddt=rng.rand(b, n).astype(np.float32), ss8_tokens=rng.randint(0, 11, (b, n)),
        sasa_tokens=rng.randint(0, 19, (b, n)), function_tokens=rng.randint(0, 260, (b, n, 8)),
        residue_tokens=(rng.rand(b, n, 4) < 0.6) * rng.randint(1, 1478, (b, n, 4)))
    with F32():
        want = np.asarray(j3.encode_inputs(params, j3.TINY, **{k: jnp.asarray(v)
                                                               for k, v in args.items()}))
    with torch.no_grad():
        got = model.encoder(**{k: torch.from_numpy(v) for k, v in args.items()}).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("with_coords", [False, True], ids=["sequence_only", "coords"])
def test_forward_matches_jax(pair, with_coords):
    params, model = pair
    seq = "MKTAYIAKQRQISFVK"
    toks = np.stack([j3.tokenize_sequence(seq)] * 2)
    toks[1, 4] = j3.SEQ_MASK
    kw = {}
    if with_coords:
        coords = np.full((2, len(seq) + 2, 3, 3), np.inf, np.float32)
        coords[:, 1:-1] = make_coords(len(seq))
        struct = np.random.RandomState(6).randint(0, 4096, toks.shape)
        struct[0, 3] = -1
        kw = dict(coords=coords, structure_tokens=struct,
                  per_res_plddt=np.isfinite(coords).all(-1).any(-1).astype(np.float32))
    with F32():
        want, want_emb = (np.asarray(a) for a in j3.forward(
            params, j3.TINY, jnp.asarray(toks), **{k: jnp.asarray(v) for k, v in kw.items()}))
    with torch.no_grad():
        got, got_emb = (a.numpy() for a in model(torch.from_numpy(toks).long(),
                                                 **{k: torch.from_numpy(v) for k, v in kw.items()}))
    assert got.shape == (2, len(seq) + 2, 64)
    np.testing.assert_allclose(got_emb, want_emb, atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_knn_sets_match_jax():
    coords = make_coords(40, 7)
    mask = np.ones(40, bool)
    mask[[3, 17]] = False
    with F32():
        want = np.asarray(j3._knn_edges(jnp.asarray(coords[:, 1]), jnp.asarray(mask), 16))
    got = t3.knn_edges(torch.from_numpy(coords[:, 1]), torch.from_numpy(mask), 16).numpy()
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
    assert (got[:, 0] == np.arange(40))[mask].all()  # self first
    # no coordinates at all: 100 |i - j| + 1e6 ties i - d with i + d, and the
    # stable sort keeps the lower index on both sides
    none = np.zeros(40, bool)
    with F32():
        want = np.asarray(j3._knn_edges(jnp.asarray(coords[:, 1]), jnp.asarray(none), 16))
    got = t3.knn_edges(torch.from_numpy(coords[:, 1]), torch.from_numpy(none), 16).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[20].tolist() == [20, 19, 21, 18, 22, 17, 23, 16, 24, 15, 25, 14, 26, 13, 27, 12]


@pytest.mark.parametrize("sc", [TINY_SC, MID_SC], ids=["tiny", "mid"])
def test_structure_tokens_match_jax(sc):
    params, encoder = encoder_pair(sc, seed=8)
    coords = make_coords(60, 9)
    with F32():
        want = j3.structure_tokens_from_coords(params, sc, coords)
    got = t3.structure_tokens_from_coords(encoder, coords)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) > 3


def _assay(n, seed):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), n))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, n, 3) for a in "AGW" if a != seq[p]]
    return seq, muts + [f"{seq[1]}2K:{seq[6]}7P", "WT", f"{seq[0]}1{seq[0]}"]


@pytest.mark.parametrize("with_coords", [False, True], ids=["sequence_only", "structure"])
def test_score_assay_matches_jax(pair, with_coords):
    params, model = pair
    sparams, encoder = encoder_pair(TINY_SC, seed=10)
    seq, muts = _assay(20, 11)
    coords = make_coords(20, 12) if with_coords else None
    with F32():
        want = j3.score_assay_esm3(params, j3.TINY, sparams, TINY_SC, seq, muts, coords=coords,
                                   batch=4)
    got = t3.score_assay_esm3(model, encoder, seq, muts, coords=coords, batch=4)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    assert got[muts.index("WT")] == 0.0 and np.isfinite(got).all()
    with pytest.raises(ValueError, match="WT mismatch"):
        bad = "A" if seq[0] != "A" else "C"
        t3.score_assay_esm3(model, encoder, seq, [f"{bad}1G"], coords=coords)


def test_structure_conditioning_moves_the_scores(pair):
    _, model = pair
    _, encoder = encoder_pair(TINY_SC, seed=10)
    seq, muts = _assay(20, 11)
    plain = t3.score_assay_esm3(model, encoder, seq, muts, batch=8)
    with_structure = t3.score_assay_esm3(model, encoder, seq, muts, coords=make_coords(20, 12),
                                         batch=8)
    assert np.abs(plain - with_structure).max() > 1e-3


@pytest.mark.parametrize("branch", ["sequence_only", "structure_checkpoint", "preset_trunk",
                                    "state_trunk_warns"])
def test_scorer_column_matches_jax(monkeypatch, tmp_path, pair, branch):
    # each structure branch of the JAX scorer (scorers_extra.py:101-138),
    # both sides on the same weights: the JAX inits patched to return them
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.data.structures import write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_esmc import scorer_contexts

    params, model = pair
    seq, muts = _assay(20, 13)
    mid = dict(MID_SC.__dict__, name="esm3_structure_encoder_mid")
    sc = j3.StructureEncoderConfig(**mid)
    sparams, encoder = encoder_pair(sc, seed=14)
    tiny_sparams, tiny_encoder = encoder_pair(TINY_SC, seed=15)
    monkeypatch.setitem(j3.STRUCTURE_ENCODER_PRESETS, sc.name, sc)
    monkeypatch.setitem(t3.STRUCTURE_ENCODER_PRESETS, sc.name, t3.StructureEncoderConfig(**mid))
    monkeypatch.setattr(j3, "init_params", lambda rng, c: params)
    monkeypatch.setattr(j3, "structure_encoder_init",
                        lambda rng, c: sparams if c.name == sc.name else tiny_sparams)
    monkeypatch.setattr(t3, "init_random", lambda config, seed, device: model)
    monkeypatch.setattr(t3, "structure_encoder_init",
                        lambda c, seed, device: encoder if c.name == sc.name else tiny_encoder)
    pdbs = tmp_path / "pdb"
    pdbs.mkdir()
    coords = make_coords(20, 16)
    write_pdb_backbone(pdbs / "P0.pdb", np.concatenate([coords, coords[:, 2:]], axis=1), seq)
    extra = {"structure_checkpoint": sc.name} if branch == "structure_checkpoint" else {}
    structure_dir = None if branch == "sequence_only" else pdbs
    jctx, tctx = scorer_contexts(seq, muts, None, dict(extra), dict(extra), structure_dir)
    if branch == "state_trunk_warns":
        # a trunk from a state dict and no structure_checkpoint=: a warning,
        # then the sequence-only scores
        tctx.extra["params"] = model.state_dict()
        jctx.structure_dir = None
        with pytest.warns(UserWarning, match="sequence-only"):
            got = tscorers.SCORERS["esm3"](tctx)["ESM3_score"]
    else:
        got = tscorers.SCORERS["esm3"](tctx)["ESM3_score"]
    with F32():
        want = jextra.score_esm3(jctx)["ESM3_score"].to_numpy()
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    if branch != "sequence_only" and branch != "state_trunk_warns":
        plain = t3.score_assay_esm3(model, None, seq, muts, batch=4)
        assert np.abs(got - plain).max() > 1e-3  # the structure track took part


def test_state_dict_files_through_the_scorer(tmp_path, pair):
    # published-layout files for the trunk and the encoder: their presets
    # found by layers and width; the file trunk with a PDB and no
    # structure_checkpoint= warns and scores sequence-only
    from proteingym_tpu_torch.data.structures import write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers
    from tests.test_torch_esmc import scorer_contexts

    _, model = pair
    _, encoder = encoder_pair(TINY_SC, seed=17)
    trunk_file, encoder_file = tmp_path / "esm3.pth", tmp_path / "encoder.pth"
    torch.save(model.state_dict(), trunk_file)
    torch.save(encoder.state_dict(), encoder_file)
    seq, muts = _assay(20, 18)
    coords = make_coords(20, 19)
    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", np.concatenate([coords, coords[:, 2:]], 1),
                       seq)
    _, tctx = scorer_contexts(seq, muts, str(trunk_file), {}, {}, tmp_path / "pdb")
    with pytest.warns(UserWarning, match="sequence-only"):
        got = tscorers.SCORERS["esm3"](tctx)["ESM3_score"]
    np.testing.assert_allclose(got, t3.score_assay_esm3(model, None, seq, muts, batch=4),
                               atol=1e-6, rtol=0)
    tctx.extra["structure_checkpoint"] = str(encoder_file)
    got = tscorers.SCORERS["esm3"](tctx)["ESM3_score"]
    pdb_coords = tscorers._load_structure(tctx)[:, :3]
    np.testing.assert_allclose(
        got, t3.score_assay_esm3(model, encoder, seq, muts, coords=pdb_coords, batch=4),
        atol=1e-6, rtol=0)
