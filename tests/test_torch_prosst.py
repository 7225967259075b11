"""The port's ProSST and VenusREM (proteingym_tpu_torch.models.prosst) against
the JAX package's, on ``prosst_tiny`` in float32: the disentangled
attention below and above ``max_relative_positions`` (the span clip), the
logits, ``score_assay_prosst_real`` (WT rows 0, a length mismatch raising),
the HF loader on the split and the fused ``in_proj`` layouts, the preset
picked by the structure vocabulary's rows, the seeded JAX init through
``params_from_jax``, VenusREM's count log-softmax, header range and
blended scores, the legacy additive scorer and the legacy ESM blend, and
the scorers' columns.

One weight set for both sides: an HF-named state dict made from a seed,
read natively by the port and by the JAX converter. The JAX side runs
inside ``jax.enable_x64(False)``.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import prosst as jp
from proteingym_tpu.models import structure_plms as jsp
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import prosst as tp
from proteingym_tpu_torch.models import structure_plms as tsp
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 on both sides through 2 post-LN layers: summation order only
# (~1e-6 relative on logits of magnitude ~1)
ATOL = 1e-4
SCORE_ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
TINY = tp.PROSST_PRESETS["prosst_tiny"]
JTINY = jp.PROSST_PRESETS["prosst_tiny"]


def hf_state(c=TINY, seed=0, fused=False, prefix="prosst."):
    """A random HF-named ProSST state dict (numpy) for ``c``; ``fused`` packs
    q/k/v into DeBERTa v1's per-head ``in_proj`` with ``q_bias``/``v_bias``."""
    with torch.device("meta"):
        names = tp.ProSST(c).state_dict()
    rng = np.random.default_rng(seed)
    sd = {}
    for name, p in names.items():
        shape = tuple(p.shape)
        if name.endswith("LayerNorm.weight"):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif len(shape) == 2 and "embeddings" not in name:
            v = rng.standard_normal(shape) / np.sqrt(shape[1])
        else:
            v = 0.3 * rng.standard_normal(shape)
        sd[name.replace("prosst.", prefix, 1) if name.startswith("prosst.") else name] = \
            v.astype(np.float32)
    if fused:
        d, h, hd = c.hidden, c.num_heads, c.head_dim
        for i in range(c.num_layers):
            a = f"{prefix}encoder.layer.{i}.attention.self"
            w = [sd.pop(f"{a}.{n}_proj.weight").reshape(h, hd, d)
                 for n in ("query", "key", "value")]
            sd[f"{a}.in_proj.weight"] = np.stack(w, 1).reshape(3 * d, d)
            sd[f"{a}.q_bias"] = sd.pop(f"{a}.query_proj.bias")
            sd[f"{a}.v_bias"] = sd.pop(f"{a}.value_proj.bias")
            sd.pop(f"{a}.key_proj.bias")
    return sd


def both(sd, c=TINY, jc=JTINY):
    with F32():
        params = jp.convert_hf_state_dict(sd, jc)
    return params, tp.load_hf_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, c,
                                         device=CPU)


def grids(b, t, seed, n_ss=16):
    rng = np.random.default_rng(seed)
    toks = np.stack([tp.tokenize_prosst("".join(rng.choice(list(AA), t - 2))) for _ in range(b)])
    ss = np.stack([tp.tokenize_structure_sequence(rng.integers(0, n_ss, t - 2))
                   for _ in range(b)])
    return toks, ss


@pytest.mark.parametrize("t", [10, 16, 29])
def test_attention_matches_jax_across_the_span_clip(t):
    params, model = both(hf_state(seed=1))
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, TINY.hidden)).astype(np.float32)
    ss = rng.standard_normal((2, t, TINY.hidden)).astype(np.float32)
    mask = np.ones((2, t), bool)
    mask[1, t - 3:] = False
    with F32():
        want = np.asarray(jp.prosst_attention(params["layers"][0], JTINY, jnp.asarray(x),
                                              jnp.asarray(ss), params["rel_embeddings"],
                                              jnp.asarray(mask)))
    layer = model.prosst.encoder.layer[0].attention
    with torch.no_grad():
        got = layer.output.dense(layer.self(torch.from_numpy(x), torch.from_numpy(ss),
                                            model.prosst.encoder.rel_embeddings.weight,
                                            torch.from_numpy(mask))).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("fused", [False, True], ids=["split", "in_proj"])
def test_logits_match_jax_on_both_layouts(fused):
    params, model = both(hf_state(seed=2, fused=fused))
    toks, ss = grids(2, 24, seed=3)
    mask = np.ones_like(toks, bool)
    mask[1, -4:] = False
    with F32():
        want = np.asarray(jp.prosst_apply(params, JTINY, jnp.asarray(toks), jnp.asarray(ss),
                                          jnp.asarray(mask)))
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(ss), torch.from_numpy(mask)).numpy()
    assert got.shape == (2, 24, 25)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_fused_and_split_layouts_load_the_same_model():
    split, fused = hf_state(seed=4), hf_state(seed=4, fused=True)
    load = lambda sd: tp.load_hf_state_dict(sd, TINY, device=CPU).state_dict()  # noqa: E731
    a, b = load(split), load(fused)
    for k in a:
        if k.endswith("key_proj.bias"):  # the fused layout has no key bias
            assert not b[k].any()
        else:
            torch.testing.assert_close(a[k], b[k], atol=0, rtol=0)
    with pytest.raises(KeyError, match="pos_proj"):
        tp.load_hf_state_dict({k: v for k, v in split.items() if "pos_proj" not in k}, TINY,
                              device=CPU)
    bare = {k.removeprefix("prosst."): v for k, v in split.items()}
    for k, v in tp.load_hf_state_dict(bare, TINY, device=CPU).state_dict().items():
        torch.testing.assert_close(v, a[k], atol=0, rtol=0)


def test_seeded_jax_init_through_params_from_jax():
    with F32():
        params = jp.prosst_init_params(jax.random.PRNGKey(3), JTINY)
        toks, ss = grids(1, 20, seed=5)
        want = np.asarray(jp.prosst_apply(params, JTINY, jnp.asarray(toks), jnp.asarray(ss)))
    model = tp.load_hf_state_dict(tp.params_from_jax(jax.device_get(params), TINY), TINY,
                                  device=CPU)
    with torch.no_grad():
        got = model(torch.from_numpy(toks), torch.from_numpy(ss)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    rnd = tp.init_random(TINY, seed=0, device=CPU)
    w = rnd.prosst.encoder.layer[0].attention.self.query_proj.weight
    assert abs(float(w.std()) / 0.02 - 1) < 0.1 and not rnd.prosst.encoder.layer[0] \
        .attention.self.query_proj.bias.any()


def _assay(length=22, seed=6):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AA), length))
    muts = [f"{seq[p]}{p + 1}{a}" for p in range(0, length, 3) for a in "AW" if a != seq[p]]
    return seq, muts + [f"{seq[1]}2K:{seq[6]}7P", "WT", f"{seq[0]}1{seq[0]}"]


def test_score_assay_matches_jax():
    params, model = both(hf_state(seed=7))
    seq, muts = _assay()
    struct = np.random.default_rng(8).integers(0, 16, len(seq))
    with F32():
        want = jp.score_assay_prosst_real(params, JTINY, seq, struct, muts)
    got = tp.score_assay_prosst_real(model, seq, struct, muts)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    assert got[-1] == 0.0 and got[-2] == 0.0
    with pytest.raises(ValueError, match="structure token count"):
        tp.score_assay_prosst_real(model, seq, struct[:-1], muts)
    with pytest.raises(ValueError, match="WT mismatch"):
        tp.score_assay_prosst_real(model, seq, struct, [f"{'A' if seq[0] != 'A' else 'C'}1G"])


def test_preset_is_found_by_the_structure_vocabulary(tmp_path, monkeypatch):
    from proteingym_tpu_torch.pipeline.checkpoints import resolve_preset_state

    presets = {"k16": TINY, "k20": dataclasses.replace(TINY, name="k20", ss_vocab_size=23)}
    monkeypatch.setattr(tp, "PROSST_PRESETS", presets)
    path = tmp_path / "pytorch_model.bin"
    torch.save({k: torch.from_numpy(v) for k, v in
                hf_state(presets["k20"], seed=9).items()}, path)
    config, state = resolve_preset_state(str(path), presets, "k16", "ProSST", tp.state_shape,
                                         tp.config_shape)
    assert config.name == "k20" and state is not None


def test_venusrem_blend_matches_jax(tmp_path):
    params, model = both(hf_state(seed=10))
    seq, muts = _assay(seed=11)
    struct = np.random.default_rng(12).integers(0, 16, len(seq))
    rng = np.random.default_rng(13)
    aa_rows = ["".join(rng.choice(list(AA + "-"), 15)) for _ in range(30)]
    ss_rows = ["".join(rng.choice(list("ACDEFGHIKLmnpq.-"), len(seq) - rng.integers(0, 4)))
               for _ in range(20)]
    fasta = tmp_path / "aln.fasta"
    fasta.write_text("".join(f">s{i}/4-18\n{r[:7]}\n{r[7:]}\n" for i, r in enumerate(aa_rows)))
    headers, seqs = tp.read_alignment_fasta(fasta)
    assert (headers, seqs) == jp.read_alignment_fasta(fasta) and seqs == aa_rows
    assert tp.parse_alignment_range(headers[0], 15) == jp.parse_alignment_range(headers[0], 15) \
        == (3, 18)
    assert tp.parse_alignment_range(">noslash", 9) == (0, 9)
    np.testing.assert_array_equal(tp.alignment_count_log_softmax(ss_rows),
                                  jp.alignment_count_log_softmax(ss_rows))
    for aa_aln, st_aln in (((headers, seqs), (["x"], ss_rows)), (None, (["x"], ss_rows)),
                           ((headers, seqs), None)):
        with F32():
            want = jp.venusrem_score_assay_real(params, JTINY, seq, struct, muts,
                                                aa_alignment=aa_aln, struct_alignment=st_aln,
                                                alpha=0.7)
        got = tp.venusrem_score_assay_real(model, seq, struct, muts, aa_alignment=aa_aln,
                                           struct_alignment=st_aln, alpha=0.7)
        np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the legacy paths, on ESM2's tiny float32 preset
# ---------------------------------------------------------------------------

JESM = jesm.PRESETS["esm2_tiny"]
TESM = tesm.PRESETS["esm2_tiny"]


def _noisy_helix(n, seed):
    coords = synthetic_helix_backbone(n, seed=seed)
    coords[:, 1] += 0.05 * np.random.RandomState(seed).randn(n, 3)
    return coords


def legacy_additive(seed=14, k=8):
    with F32():
        params = jax.device_get(jp.prosst_init(jax.random.PRNGKey(seed), JESM, k_structure=k))
    model = tp.StructureConditionedEsm(
        tesm.load_fair_esm_state_dict(tesm.params_from_jax(params, TESM), TESM, device=CPU), k + 1)
    with torch.no_grad():
        model.structure_embed.copy_(torch.from_numpy(np.array(params["structure_embed"])))
    return params, model


def test_structure_states_and_additive_scores_match_jax():
    seq, muts = _assay(24, seed=15)
    coords = _noisy_helix(len(seq), 16)
    with F32():
        want_states = jp.structure_token_ids(coords, 8)
    np.testing.assert_array_equal(tp.structure_token_ids(coords, 8), want_states)
    assert len(set(want_states)) > 2
    params, model = legacy_additive()
    with F32():
        want = jp.score_assay_prosst(params, JESM, coords, seq, muts, k_structure=8, chunk=5)
    got = tp.score_assay_prosst(model, coords, seq, muts, k_structure=8, chunk=5)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    assert got[-1] == 0.0 and got[-2] == 0.0


def test_legacy_esm_blend_matches_jax():
    seq, muts = _assay(20, seed=17)
    with F32():
        params = jax.device_get(jesm.init_params(jax.random.PRNGKey(18), JESM))
    model = tesm.load_fair_esm_state_dict(tesm.params_from_jax(params, TESM), TESM, device=CPU)
    rng = np.random.default_rng(19)
    aln = ["".join(rng.choice(list(AA + "-x"), len(seq))) for _ in range(25)]
    struct = ["".join(rng.choice(list(AA.lower()), len(seq))) for _ in range(12)]
    np.testing.assert_array_equal(tsp.alignment_count_logits(aln),
                                  jsp.alignment_count_logits(aln))
    w = rng.random(25)
    np.testing.assert_allclose(tsp.alignment_count_logits(aln, w, 0.3),
                               jsp.alignment_count_logits(aln, w, 0.3), rtol=1e-15, atol=0)
    with F32():
        want = jsp.venusrem_score_assay(params, JESM, seq, muts, seq_alignment=aln,
                                        struct_alignment=struct, chunk=6)
    got = tsp.venusrem_score_assay(model, seq, muts, seq_alignment=aln, struct_alignment=struct,
                                   chunk=6)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the scorers
# ---------------------------------------------------------------------------


def _contexts(seq, muts, checkpoint, jax_extra, port_extra, structure_dir=None, msa=None):
    from tests.test_torch_esmc import scorer_contexts

    jctx, tctx = scorer_contexts(seq, muts, checkpoint, jax_extra, port_extra, structure_dir)
    for ctx in (jctx, tctx):
        ctx.record = types.SimpleNamespace(**vars(ctx.record), MSA_filename=None)
    return jctx, tctx


def _pdb_dir(tmp_path, seq, seed=20):
    from proteingym_tpu_torch.data.structures import write_pdb_backbone

    (tmp_path / "pdb").mkdir()
    write_pdb_backbone(tmp_path / "pdb" / "P0.pdb", _noisy_helix(len(seq), seed), seq)
    return tmp_path / "pdb"


@pytest.mark.parametrize("source", ["tridi", "fasta"])
def test_prosst_scorer_column_matches_jax(tmp_path, monkeypatch, source):
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    sd = hf_state(seed=21)
    params, _ = both(sd)
    seq, muts = _assay(20, seed=22)
    pdbs = _pdb_dir(tmp_path, seq)
    monkeypatch.setattr(jp, "prosst_init_params", lambda rng, c: params)
    extra = {}
    if source == "fasta":
        (tmp_path / "ss").mkdir()
        toks = np.random.default_rng(23).integers(0, 16, len(seq))
        (tmp_path / "ss" / "SYN.fasta").write_text(">x\n" + ",".join(map(str, toks)) + "\n")
        extra = {"structure_fasta_dir": str(tmp_path / "ss")}
    jctx, tctx = _contexts(seq, muts, "prosst_tiny", extra,
                           dict(extra, params={k: torch.from_numpy(v) for k, v in sd.items()}),
                           structure_dir=pdbs)
    with F32():
        want = jextra.score_prosst(jctx)["prosst_tiny_score"].to_numpy()
    got = tscorers.SCORERS["prosst"](tctx)
    assert list(got) == ["prosst_tiny_score"]
    np.testing.assert_allclose(got["prosst_tiny_score"], want, atol=SCORE_ATOL, rtol=0)


def test_prosst_additive_and_venusrem_columns_match_jax(tmp_path, monkeypatch):
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    seq, muts = _assay(20, seed=24)
    pdbs = _pdb_dir(tmp_path, seq)
    # the legacy additive scorer, k=8 states over ESM2's tiny preset
    params, model = legacy_additive(seed=25)
    monkeypatch.setattr(jp, "prosst_init", lambda rng, c, k_structure: params)
    monkeypatch.setattr(tp, "prosst_init", lambda c, k_structure, seed, device: model)
    extra = {"method": "additive", "esm_checkpoint": "esm2_tiny", "k_structure": "8"}
    jctx, tctx = _contexts(seq, muts, None, extra, extra, structure_dir=pdbs)
    with F32():
        want = jextra.score_prosst(jctx)["ProSST_8_score"].to_numpy()
    got = tscorers.SCORERS["prosst"](tctx)
    assert list(got) == ["ProSST_8_score"]
    np.testing.assert_allclose(got["ProSST_8_score"], want, atol=SCORE_ATOL, rtol=0)
    # VenusREM with a residue and a structure alignment
    sd = hf_state(seed=26)
    vparams, _ = both(sd)
    monkeypatch.setattr(jp, "prosst_init_params", lambda rng, c: vparams)
    rng = np.random.default_rng(27)
    for name, rows in (("aa", [seq] + ["".join(rng.choice(list(AA + "-"), len(seq)))
                                       for _ in range(9)]),
                       ("st", ["".join(rng.choice(list(AA), len(seq))) for _ in range(7)])):
        (tmp_path / name).mkdir()
        (tmp_path / name / "P0.fasta").write_text(
            "".join(f">r{i}/1-{len(seq)}\n{r}\n" for i, r in enumerate(rows)))
    extra = {"aa_seq_aln_dir": str(tmp_path / "aa"), "struc_seq_aln_dir": str(tmp_path / "st"),
             "alpha": "0.6"}
    jctx, tctx = _contexts(seq, muts, None, extra,
                           dict(extra, params={k: torch.from_numpy(v) for k, v in sd.items()}),
                           structure_dir=pdbs)
    with F32():
        want = jextra.score_venusrem(jctx)["VenusREM_score"].to_numpy()
    got = tscorers.SCORERS["venusrem"](tctx)
    assert list(got) == ["VenusREM_score"]
    np.testing.assert_allclose(got["VenusREM_score"], want, atol=SCORE_ATOL, rtol=0)


def test_unknown_checkpoint_raises():
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    seq, muts = _assay(12, seed=28)
    _, tctx = _contexts(seq, muts, "prosst_nonesuch", {}, {})
    with pytest.raises(ValueError, match="not a preset"):
        tscorers.SCORERS["prosst"](tctx)
