"""The port's MSA Transformer (proteingym_tpu_torch.models.msa_transformer)
against the JAX package's, on ``msa_tiny`` in float32 (bf16 in the JAX
package, so its side gets ``dtype=float32``): logits through the fair-esm
state-dict bridge and from JAX's ``init_params``, the weighted sampling and
tokenisation (identical), the masked-marginal tables on the short path
(k = 1 and k = 3 columns per forward) and the windowed path, the seed
ensemble, the focus-column remap, and the ``msa_transformer`` scorer
through the port's CLI.

On CPU tensors the column attention takes ``plain_mha``, so these tests
hold the model around the kernel to the JAX ``apply``; the kernel itself
is held to the same plain version on the card.
"""

import csv
import dataclasses
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.models import msa_transformer as jmt
from proteingym_tpu.msa.parser import load_msa as jload_msa
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu_torch.models import msa_transformer as tmt
from proteingym_tpu_torch.msa.parser import load_msa as tload_msa
from proteingym_tpu_torch.pipeline import checkpoints as tckpt
from proteingym_tpu_torch.pipeline import cli as tcli
from proteingym_tpu_torch.pipeline import scorers as tscorers

# float32 on both sides; sums run in other orders (the tied row scores sum
# R * head_dim products, the column softmax is scaled before or after q.k)
ATOL = 1e-4
AA = "ACDEFGHIKLMNPQRSTVWY"
TINY = tmt.PRESETS["msa_tiny"]
JAX_TINY = dataclasses.replace(jmt.PRESETS["msa_tiny"], dtype=jnp.float32)


def fair_esm_state(config, seed, prefix=""):
    """A fair-esm MSATransformer state dict with every weight random (LN
    scales around 1), plus the keys the port ignores (tied LM-head weight,
    contact head), as numpy float32."""
    rng = np.random.default_rng(seed)
    d, f, v = config.embed_dim, config.ffn_dim, config.alphabet_size

    def w(*shape, scale=0.2):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = 1 + w(d, scale=0.1), w(d, scale=0.1)

    sd = {"embed_tokens.weight": w(v, d), "embed_positions.weight": w(config.max_positions + 2, d),
          "msa_position_embedding": w(1, config.max_rows, 1, d, scale=0.1)}
    ln("emb_layer_norm_before")
    ln("emb_layer_norm_after")
    for i in range(config.num_layers):
        for mod in ("row_self_attention", "column_self_attention"):
            for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sd[f"layers.{i}.{mod}.layer.{proj}.weight"] = w(d, d)
                sd[f"layers.{i}.{mod}.layer.{proj}.bias"] = w(d)
            ln(f"layers.{i}.{mod}.layer_norm")
        p = f"layers.{i}.feed_forward_layer"
        sd[f"{p}.layer.fc1.weight"], sd[f"{p}.layer.fc1.bias"] = w(f, d), w(f)
        sd[f"{p}.layer.fc2.weight"], sd[f"{p}.layer.fc2.bias"] = w(d, f, scale=0.1), w(d)
        ln(f"{p}.layer_norm")
    sd["lm_head.dense.weight"], sd["lm_head.dense.bias"] = w(d, d), w(d)
    ln("lm_head.layer_norm")
    sd["lm_head.bias"] = w(v)
    sd["lm_head.weight"] = sd["embed_tokens.weight"]
    sd["contact_head.regression.weight"] = w(1, config.num_layers * config.num_heads)
    return {prefix + k: val for k, val in sd.items()}


def _both(seed=0):
    sd = fair_esm_state(TINY, seed)
    model = tmt.load_fair_esm_state_dict(sd, TINY, device="cpu")
    jparams = jmt.convert_torch_state_dict(sd, JAX_TINY)
    return model, jparams


def _family(rs, n, length):
    focus = "".join(AA[i] for i in rs.randint(0, 20, length))
    seqs = [focus]
    for _ in range(n - 1):
        s = list(focus)
        for p in rs.choice(length, max(1, length // 4), replace=False):
            s[p] = AA[rs.randint(20)] if rs.rand() > 0.2 else "-"
        seqs.append("".join(s))
    return focus, seqs


_japply = jax.jit(jmt.apply, static_argnums=1)


def _logits(model, jparams, tokens):
    got = model(torch.from_numpy(tokens).long()).numpy()
    want = np.asarray(_japply(jparams, JAX_TINY, jnp.asarray(tokens)))
    return got, want


def _jax_table(jparams, tokens, **kw):
    return np.asarray(jmt.masked_marginal_table_msa(
        lambda p, t: jmt.apply(p, JAX_TINY, t), tokens, params=jparams, **kw))


def test_presets_match_jax_shapes():
    for name, jcfg in jmt.PRESETS.items():
        tcfg = tmt.PRESETS[name]
        for field in ("num_layers", "embed_dim", "num_heads", "ffn_dim", "alphabet_size",
                      "max_positions", "max_rows"):
            assert getattr(tcfg, field) == getattr(jcfg, field), (name, field)
    assert tmt.PRESETS["esm_msa1b_t12_100M"].dtype == torch.bfloat16
    assert TINY.dtype == torch.float32


@pytest.mark.parametrize("prefix", ["", "encoder."])
def test_logits_with_a_padded_column_match_jax_through_state_dict(prefix):
    # both load one fair-esm state dict: the port natively, JAX through
    # convert_torch_state_dict; three rows of which the last column is padding
    sd = fair_esm_state(TINY, 1, prefix=prefix)
    model = tmt.load_fair_esm_state_dict(sd, TINY, device="cpu")
    jparams = jmt.convert_torch_state_dict(sd, JAX_TINY)
    rs = np.random.RandomState(2)
    _, seqs = _family(rs, 6, 11)
    tokens = np.stack([jmt.tokenize_msa(seqs)] * 2)
    tokens[:, :, -1] = jmt.ALPHABET.padding_idx
    tokens[1, 0, 3] = jmt.ALPHABET.mask_idx
    got, want = _logits(model, jparams, tokens)
    assert got.shape == (2, 6, 12, TINY.alphabet_size)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_logits_match_jax_from_init_params():
    jparams = jax.jit(jmt.init_params, static_argnums=1)(jax.random.PRNGKey(3), JAX_TINY)
    model = tmt.load_fair_esm_state_dict(
        tmt.params_from_jax(jax.tree.map(np.asarray, jparams), TINY), TINY, device="cpu")
    _, seqs = _family(np.random.RandomState(3), 5, 9)
    got, want = _logits(model, jparams, jmt.tokenize_msa(seqs)[None])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_one_row_takes_the_value_shortcut_as_jax():
    model, jparams = _both(4)
    tokens = jmt.tokenize_msa(["ACDEFGHIKL"])[None]
    got, want = _logits(model, jparams, tokens)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_query_row_only_equals_row_zero_of_the_full_logits():
    model, _ = _both(5)
    _, seqs = _family(np.random.RandomState(5), 7, 13)
    tokens = torch.from_numpy(jmt.tokenize_msa(seqs)[None].repeat(2, 0)).long()
    tokens[1, 0, 4] = jmt.ALPHABET.mask_idx
    full = model(tokens)
    row0 = model(tokens, query_row_only=True)
    assert row0.shape == (2, 1, 14, TINY.alphabet_size)
    torch.testing.assert_close(row0, full[:, :1], atol=1e-6, rtol=0)


def test_row_permutation_equivariance_of_the_first_row():
    # with the row-order embedding zeroed, shuffling the non-focus rows
    # leaves row 0's logits unchanged (tied row + column attention)
    model, _ = _both(6)
    model.msa_position_embedding.zero_()
    rs = np.random.RandomState(6)
    _, seqs = _family(rs, 8, 10)
    tokens = jmt.tokenize_msa(seqs)
    perm = np.concatenate([[0], 1 + rs.permutation(7)])
    a = model(torch.from_numpy(tokens[None]).long())[0, 0]
    b = model(torch.from_numpy(tokens[perm][None]).long())[0, 0]
    torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_loader_rejects_missing_and_misshapen_weights():
    sd = fair_esm_state(TINY, 7)
    del sd["layers.1.column_self_attention.layer.v_proj.bias"]
    with pytest.raises(KeyError, match="v_proj.bias"):
        tmt.load_fair_esm_state_dict(sd, TINY, device="cpu")
    sd = fair_esm_state(TINY, 7)
    sd["msa_position_embedding"] = sd["msa_position_embedding"][0]
    with pytest.raises(ValueError, match="msa_position_embedding"):
        tmt.load_fair_esm_state_dict(sd, TINY, device="cpu")


def test_init_random_is_seeded_and_on_the_requested_device():
    a = tmt.init_random(TINY, seed=1, device="cpu").state_dict()
    b = tmt.init_random(TINY, seed=1, device="cpu").state_dict()
    c = tmt.init_random(TINY, seed=2, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed_tokens.weight"], c["embed_tokens.weight"])
    assert float(a["msa_position_embedding"].std()) == pytest.approx(0.01, rel=0.1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmt.init_random(TINY, seed=1)  # the default is the card


@pytest.mark.parametrize("seed", [1, 2, 7])
def test_sampling_and_tokens_equal_jax(seed):
    rs = np.random.RandomState(seed)
    _, seqs = _family(rs, 30, 12)
    seqs = [s.lower() if i % 3 == 1 else s for i, s in enumerate(seqs)]
    w = rs.rand(30)
    got = tmt.sample_msa_weighted(seqs, w, nseq=16, seed=seed)
    want = jmt.sample_msa_weighted(seqs, w, nseq=16, seed=seed)
    assert got == want and got[0] == seqs[0].upper() and len(got) == 16
    np.testing.assert_array_equal(tmt.tokenize_msa(got), jmt.tokenize_msa(want))


def test_weights_bias_the_sampling():
    out = tmt.sample_msa_weighted(["AAAA", "CCCC", "DDDD"], np.array([1.0, 100.0, 1e-9]),
                                  nseq=50, seed=0)
    assert out.count("CCCC") > 40 and out.count("DDDD") == 0


@pytest.mark.parametrize("k,length,chunk", [(1, 12, 4), (3, 13, 3)])
def test_short_table_matches_jax(k, length, chunk):
    # length 13 -> 14 columns with the CLS: k = 3 does not divide it, so
    # the last grid has a pad slot and the grid count a tail chunk
    model, jparams = _both(8)
    _, seqs = _family(np.random.RandomState(8), 5, length)
    tokens = jmt.tokenize_msa(seqs)
    got = tmt.masked_marginal_table_msa(model, tokens, chunk=chunk, cols_per_forward=k)
    want = _jax_table(jparams, tokens, chunk=chunk, cols_per_forward=k)
    assert got.shape == (length + 1, TINY.alphabet_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_k_column_rows_equal_a_manual_forward_of_their_grid():
    # each row of the k = 3 table is the masked column's row-0 log-softmax
    # of the forward that masks exactly its grid's max-stride columns
    model, _ = _both(9)
    _, seqs = _family(np.random.RandomState(9), 4, 13)
    tokens = jmt.tokenize_msa(seqs)
    total, k = tokens.shape[1], 3
    table = tmt.masked_marginal_table_msa(model, tokens, chunk=2, cols_per_forward=k)
    offsets, valid = tmt._k_column_grids(total, k, chunk=2)
    n_grids = -(-total // k)
    for g in range(n_grids):
        cols = offsets[g][valid[g]]
        assert (np.diff(np.sort(cols)) >= n_grids).all()
        masked = tokens.copy()
        masked[0, cols] = jmt.ALPHABET.mask_idx
        logps = torch.log_softmax(model(torch.from_numpy(masked[None]).long())[0, 0], -1)
        torch.testing.assert_close(table[cols], logps[cols], atol=ATOL, rtol=0)
    assert not valid[n_grids:].any() and len(offsets) % 2 == 0


def test_windowed_table_matches_jax():
    # 60 columns through windows of 48: every row from its optimal window
    model, jparams = _both(10)
    _, seqs = _family(np.random.RandomState(10), 3, 59)
    tokens = jmt.tokenize_msa(seqs)
    got = tmt.masked_marginal_table_msa(model, tokens, chunk=4, window=48)
    want = np.asarray(jmt.masked_marginal_table_msa(
        lambda t: jmt.apply(jparams, JAX_TINY, t), tokens, chunk=4, window=48))
    assert got.shape == (60, TINY.alphabet_size)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_seed_ensemble_matches_jax():
    model, jparams = _both(11)
    rs = np.random.RandomState(11)
    focus, seqs = _family(rs, 20, 10)
    w = rs.rand(20)
    muts = [f"{focus[2]}3{'A' if focus[2] != 'A' else 'C'}",
            f"{focus[5]}6{'W' if focus[5] != 'W' else 'Y'}",
            f"{focus[0]}1{'K' if focus[0] != 'K' else 'P'}:{focus[9]}10{'G' if focus[9] != 'G' else 'H'}",
            "WT"]
    kw = dict(nseq=6, seeds=(1, 2), chunk=3)
    got = tmt.score_assay_msa_transformer(model, focus, muts, seqs, w, **kw)
    want = jmt.score_assay_msa_transformer(jparams, JAX_TINY, focus, muts, seqs, w, **kw)
    assert got.shape == (4,) and got[3] == 0.0
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


def _write_a2m(path, name, seqs, start):
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            head = f">{name}/{start}-{start + len(s) - 1}" if i == 0 else f">{name}_h{i}/1-{len(s)}"
            f.write(f"{head}\n{s}\n")


def _focus_world(tmp_path, msa_start=5):
    """A 30-residue target whose alignment covers residues msa_start ..
    msa_start + 19, and mutants: in-focus singles, a double, a wrong
    wild-type letter, one outside the focus, one malformed, and WT."""
    rs = np.random.RandomState(12)
    target = "".join(AA[i] for i in rs.randint(0, 20, 30))
    focus = target[msa_start - 1:msa_start + 19]
    _, seqs = _family(rs, 24, 20)
    seqs[0] = focus
    (tmp_path / "msa").mkdir(exist_ok=True)
    _write_a2m(tmp_path / "msa" / "FAM.a2m", "FAM", seqs, msa_start)

    def sub(p, a):  # 1-based target position
        return f"{target[p - 1]}{p}{a if target[p - 1] != a else 'G'}"

    wrong = next(a for a in AA if a != target[msa_start + 2])
    mutants = [sub(msa_start, "W"), sub(msa_start + 7, "A"), sub(msa_start + 19, "D"),
               f"{sub(msa_start + 1, 'P')}:{sub(msa_start + 11, 'K')}",
               f"{wrong}{msa_start + 3}A", sub(msa_start + 25, "A"), sub(1, "C"),
               "X9", "WT"]
    unmappable = [False, False, False, False, True, True, True, True, False]
    return target, mutants, np.asarray(unmappable)


def test_focus_remap_matches_jax(tmp_path):
    target, mutants, unmappable = _focus_world(tmp_path)
    tmsa, jmsa = tload_msa(tmp_path / "msa" / "FAM.a2m"), jload_msa(tmp_path / "msa" / "FAM.a2m")
    ctx = types.SimpleNamespace(record=types.SimpleNamespace(MSA_start=5))
    seen = {}

    def score_fn(tag):
        def fn(wt, remapped):  # a score that depends on the remapped text
            seen[tag] = (wt, list(remapped))
            return [float(sum(map(ord, m))) for m in remapped]
        return fn

    got = tscorers._score_focus_model(ctx, tmsa, score_fn("port"), mutants)
    want = jscorers._score_focus_model(ctx, jmsa, score_fn("jax"), mutants)
    assert seen["port"] == seen["jax"]
    np.testing.assert_array_equal(np.isnan(got), unmappable)
    np.testing.assert_array_equal(got, want)


def test_cli_scores_msa_transformer_like_the_jax_scorer(tmp_path):
    target, mutants, unmappable = _focus_world(tmp_path)
    with open(tmp_path / "ref.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
        w.writerow(["FAM_TEST", "FAM_TEST.csv", "P1", target, 30, "FAM.a2m", 5, 24, 0.2,
                    "FAM.npy"])
    # the assay brings its own mutated_sequence column: the CLI would
    # otherwise apply each mutant to the target, which the malformed and
    # wrong-letter rows refuse
    (tmp_path / "dms").mkdir()
    with open(tmp_path / "dms" / "FAM_TEST.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["mutant", "mutated_sequence"])
        w.writerows([m, target] for m in mutants)
    out = tmp_path / "out"
    rc = tcli.main([
        "score", "--model", "msa_transformer", "--checkpoint", "msa_tiny", "--device", "cpu",
        "--msa-dir", str(tmp_path / "msa"), "--weights-dir", str(tmp_path / "w"),
        "--dms-reference", str(tmp_path / "ref.csv"), "--dms-dir", str(tmp_path / "dms"),
        "--output-dir", str(out), "--batch-size", "16", "--quiet",
        "--extra", "msa_samples=8", "num_seeds=2",
    ])
    assert rc == 0
    with open(out / "FAM_TEST.csv", newline="") as f:
        written = list(csv.DictReader(f))
    assert list(written[0]) == ["mutant", "mutated_sequence", "esm_msa1b_ensemble"]
    cells = [r["esm_msa1b_ensemble"] for r in written]
    assert [c == "" for c in cells] == list(unmappable)
    got = np.asarray([float(c) if c else np.nan for c in cells])
    assert got[-1] == 0.0 and np.isfinite(got[~unmappable]).all()
    assert len(set(got[:4])) == 4

    # the JAX scorer's functions on the same weights, MSA and weights file
    model = tmt.init_random(TINY, seed=0, device="cpu")
    jparams = jmt.convert_torch_state_dict(model.state_dict(), JAX_TINY)
    jmsa = jload_msa(tmp_path / "msa" / "FAM.a2m")
    weights = np.load(tmp_path / "w" / "FAM.npy")
    ctx = types.SimpleNamespace(record=types.SimpleNamespace(MSA_start=5))
    want = jscorers._score_focus_model(
        ctx, jmsa,
        lambda wt, remapped: jmt.score_assay_msa_transformer(
            jparams, JAX_TINY, wt, remapped, jmsa.sequences(), weights, nseq=8,
            seeds=(1, 2), chunk=2),
        mutants)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_checkpoint_specs(tmp_path, monkeypatch):
    model, config = tckpt.load_msa_transformer_checkpoint("msa_tiny", device="cpu")
    assert config is TINY and isinstance(model, tmt.MsaTransformer)
    # a file is read with the full preset's config: made tiny here, bf16 kept
    full = dataclasses.replace(TINY, name="esm_msa1b_t12_100M", dtype=torch.bfloat16)
    monkeypatch.setitem(tmt.PRESETS, "esm_msa1b_t12_100M", full)
    sd = {f"encoder.{k}": torch.from_numpy(v) for k, v in fair_esm_state(full, 0).items()}
    torch.save({"model": sd}, tmp_path / "msa1b.pt")
    model, config = tckpt.load_msa_transformer_checkpoint(str(tmp_path / "msa1b.pt"),
                                                          device="cpu")
    assert config.name == "esm_msa1b_t12_100M"
    assert model.layers[1].column_self_attention.layer.v_proj.weight.dtype == torch.bfloat16
    torch.testing.assert_close(model.msa_position_embedding.float(),
                               sd["encoder.msa_position_embedding"].bfloat16().float())
