"""The port's SaProt (proteingym_tpu_torch.models.saprot) and its 3Di
tokens (proteingym_tpu_torch.ops.tridi) against the JAX package's: the
descriptors, partners, letters and the default codebook on noisy helices,
both vocabularies, ``score_mutants`` on a tiny float32 ESM2 trunk over
SaProt's vocabulary, and the scorer's column (3Di letters from a PDB and
from a ``tridi_dir`` FASTA).

One weight set for both sides: a fair-esm-named state dict made from a
seed, read by the port's ESM2 loader and the JAX converter. The JAX side
runs inside ``jax.enable_x64(False)`` (its virtual CB in float32, as in
production).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import saprot as js
from proteingym_tpu.ops import tridi as jt
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import saprot as ts
from proteingym_tpu_torch.ops import tridi as tt
from tests.test_torch_esm2 import fair_esm_state
from tests.test_torch_eve_train import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = torch.device("cpu")
F32 = lambda: jax.enable_x64(False)  # noqa: E731
# float32 trunks on both sides: log-prob masses agree to ~1e-6 relative,
# each score sums 1-3 log ratios
SCORE_ATOL = 1e-5
AA = "ACDEFGHIKLMNPQRSTVWY"
JTINY = dataclasses.replace(jesm.EsmConfig("saprot_tiny", 2, 64, 4), dtype=jnp.float32,
                            alphabet_size=js.VOCAB.size)
TTINY = dataclasses.replace(tesm.EsmConfig("saprot_tiny", 2, 64, 4), dtype=torch.float32,
                            alphabet_size=ts.VOCAB.size)


def noisy(n, seed, noise):
    return synthetic_helix_backbone(n, seed=seed) + noise * np.random.RandomState(seed).randn(
        n, 4, 3)


@pytest.mark.parametrize("noise", [0.0, 0.3, 1.0])
def test_descriptors_tokens_and_letters_match_jax(noise):
    coords = noisy(70, seed=int(10 * noise), noise=noise)
    with F32():
        jd, jp = jt.tridi_descriptors(coords)
        jl = jt.structure_letters(coords)
    td, tp = tt.tridi_descriptors(coords)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(td, jd)
    assert tt.structure_letters(coords) == jl and set(jl) <= set(tt.TRIDI_VOCAB)


def test_default_codebook_and_kmeans_match_jax():
    with F32():
        want = jt.default_codebook()
    np.testing.assert_array_equal(tt.default_codebook(), want)
    x = np.random.RandomState(0).randn(50, 10)
    np.testing.assert_array_equal(tt.train_codebook(x, k=7, iters=5, seed=3),
                                  jt.train_codebook(x, k=7, iters=5, seed=3))


def test_vocabularies_match_jax(tmp_path):
    assert ts.VOCAB.size == js.VOCAB.size == 467
    for aa in AA + "X#B":
        for c in tt.TRIDI_VOCAB + "#?":
            assert ts.VOCAB.pair_id(aa, c) == js.VOCAB.pair_id(aa, c)
        assert ts.VOCAB.aa_block(aa) == js.VOCAB.aa_block(aa)
    np.testing.assert_array_equal(ts.VOCAB.tokenize("ACX#", "pyc#"),
                                  js.VOCAB.tokenize("ACX#", "pyc#"))
    # a published-style vocab.txt: specials, then residue x 3Di pairs
    toks = ["<cls>", "<pad>", "<eos>", "<unk>", "<mask>"]
    toks += [a + c for a in AA + "#" for c in ts.SaProtFileVocab.struc_chars]
    (tmp_path / "vocab.txt").write_text("\n".join(toks) + "\n")
    jv, tv = js.SaProtFileVocab(tmp_path / "vocab.txt"), ts.SaProtFileVocab(tmp_path / "vocab.txt")
    assert tv.size == jv.size and tv.mask_idx == jv.mask_idx
    for aa in AA + "X#":
        assert tv.aa_block(aa) == jv.aa_block(aa)
        for c in tt.TRIDI_VOCAB + "#?":
            assert tv.pair_id(aa, c) == jv.pair_id(aa, c)
    toks[6], toks[7] = toks[7], toks[6]  # a 3Di block out of order
    (tmp_path / "bad.txt").write_text("\n".join(toks) + "\n")
    with pytest.raises(ValueError, match="contiguous 3Di-block"):
        ts.SaProtFileVocab(tmp_path / "bad.txt")
    with pytest.raises(ValueError, match="3Di string"):
        ts.VOCAB.tokenize("ACD", "py")


@pytest.fixture(scope="module")
def world():
    sd = fair_esm_state(TTINY, seed=4)
    return types.SimpleNamespace(sd=sd, params=jesm.convert_torch_state_dict(sd, JTINY),
                                 model=tesm.load_fair_esm_state_dict(sd, TTINY, device="cpu"))


def _mutants(seq, rng, n=12):
    out = []
    for _ in range(n):
        sites = sorted(rng.choice(len(seq), rng.integers(1, 3), replace=False))
        out.append(":".join(f"{seq[p]}{p + 1}{rng.choice([a for a in AA if a != seq[p]])}"
                            for p in sites))
    return out


def test_score_mutants_matches_jax(world):
    rng = np.random.default_rng(2)
    seq = "".join(rng.choice(list(AA), 30))
    struc = "".join(rng.choice(list(tt.TRIDI_VOCAB), 30))
    muts = _mutants(seq, rng)
    with F32():
        want = js.score_mutants(world.params, JTINY, seq, struc, muts, batch_size=5)
    got = ts.score_mutants(world.model, seq, struc, muts, batch_size=5)
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=0)
    with pytest.raises(ValueError, match="WT mismatch"):
        ts.score_mutants(world.model, seq, struc, [f"{AA[(AA.index(seq[0]) + 1) % 20]}1A"])


@pytest.mark.parametrize("source", ["pdb", "tridi_dir"])
def test_scorer_column_matches_jax(world, tmp_path, monkeypatch, source):
    """``saprot`` on both scorers with one weight set (the JAX preset and
    init patched to the tiny config and its weights; the port's default
    preset patched to the tiny config and given the weights as
    ``extra["params"]``)."""
    import pandas as pd

    from proteingym_tpu.pipeline import scorers as jscorers
    from proteingym_tpu.pipeline import scorers_extra as jextra
    from proteingym_tpu_torch.data.structures import write_pdb_backbone
    from proteingym_tpu_torch.pipeline import scorers as tscorers

    rng = np.random.default_rng(6)
    seq = "".join(rng.choice(list(AA), 28))
    write_pdb_backbone(tmp_path / "P0.pdb", noisy(28, seed=6, noise=0.4), seq)
    extra = {}
    if source == "tridi_dir":
        (tmp_path / "SYN.fasta").write_text(">SYN\n" + "".join(
            rng.choice(list(tt.TRIDI_VOCAB.upper()), 28)) + "\n")
        extra = {"tridi_dir": str(tmp_path)}
    muts = _mutants(seq, rng)
    monkeypatch.setattr(js, "saprot_config", lambda preset="saprot_650M": JTINY)
    monkeypatch.setattr(jesm, "init_params", lambda rng, c: world.params)
    monkeypatch.setitem(ts.PRESETS, "saprot_35M", TTINY)
    rec = types.SimpleNamespace(target_seq=seq, UniProt_ID="P0", DMS_id="SYN")
    jctx = jscorers.ScoreContext(record=rec, dms_frame=pd.DataFrame(
        {"mutant": muts, "mutated_sequence": [""] * len(muts)}), structure_dir=tmp_path,
        batch_size=4, extra=extra)
    tctx = tscorers.ScoreContext(
        record=rec, mutants=muts, device=CPU, structure_dir=tmp_path, batch_size=4,
        extra=dict(extra, params={k: torch.from_numpy(v) for k, v in world.sd.items()}))
    with F32():
        want = jextra.score_saprot(jctx)["SaProt_score"].to_numpy()
    got = tscorers.SCORERS["saprot"](tctx)
    assert list(got) == ["SaProt_score"]
    np.testing.assert_allclose(got["SaProt_score"], want, atol=SCORE_ATOL, rtol=0)


def test_presets_and_checkpoint_files(tmp_path):
    from proteingym_tpu_torch.pipeline.checkpoints import _block_count, resolve_preset_state

    for name in ("saprot_35M", "saprot_650M"):
        with F32():
            want = js.saprot_config(name)
        got = ts.PRESETS[name]
        assert (got.num_layers, got.embed_dim, got.num_heads, got.alphabet_size) == (
            want.num_layers, want.embed_dim, want.num_heads, want.alphabet_size)
        assert got.dtype == torch.bfloat16 and got.use_rotary and got.token_dropout
    shape = lambda sd: (_block_count(sd, "layers."),  # noqa: E731
                        int(np.asarray(sd["embed_tokens.weight"]).shape[1]))
    dims = lambda c: (c.num_layers, c.embed_dim)  # noqa: E731
    sd = fair_esm_state(dataclasses.replace(ts.PRESETS["saprot_35M"], dtype=torch.float32), 0)
    path = tmp_path / "SaProt_35M_AF2.pt"
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    config, state = resolve_preset_state(str(path), ts.PRESETS, "saprot_35M", "SaProt",
                                         shape, dims)
    assert config is ts.PRESETS["saprot_35M"] and "layers.11.fc2.weight" in state
    with pytest.raises(ValueError, match="Unknown SaProt"):
        resolve_preset_state("saprot_3B", ts.PRESETS, "saprot_35M", "SaProt", shape, dims)
