"""The port's packed scoring path (proteingym_tpu_torch.models.packed_scoring,
the packed scorer and ``score --packed``) against the JAX package on the
same weights and inputs, float32 on the CPU.

Weights cross through ``params_from_jax``: the JAX ``esm2_tiny`` preset is
initialised from a seed, and the port loads the same pytree as a fair-esm
state dict. Host bookkeeping (work grouping, row planning) must be equal;
tables and scores agree to float32 summation noise (ATOL).
"""

import csv
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from proteingym_tpu.models import esm2 as jesm
from proteingym_tpu.models import packed_scoring as jps
from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu_torch.models import esm2 as tesm
from proteingym_tpu_torch.models import esm_scoring as tsc
from proteingym_tpu_torch.models import packed_scoring as tps
from proteingym_tpu_torch.pipeline import cli as tcli

ATOL = 1e-4  # float32 log-probs through two layers on both sides
AA = "ACDEFGHIKLMNPQRSTVWY"
ALPHABET = tesm.ALPHABET


@pytest.fixture(scope="module")
def models():
    jcfg = jesm.PRESETS["esm2_tiny"]
    params = jesm.init_params(jax.random.PRNGKey(3), jcfg)
    tcfg = tesm.PRESETS["esm2_tiny"]
    sd = tesm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg)
    return params, jcfg, tesm.load_fair_esm_state_dict(sd, tcfg), sd


def _seq(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list(AA), n))


def _assay(n, seed, n_mut=12):
    seq = _seq(n, seed)
    rng = np.random.default_rng(seed + 100)
    muts = []
    for p in rng.choice(n, size=min(n, n_mut), replace=False):
        aa = rng.choice([a for a in AA if a != seq[p]])
        muts.append(f"{seq[p]}{p + 1}{aa}")
    muts.append(f"{seq[0]}1{'A' if seq[0] != 'A' else 'C'}:{seq[n - 1]}{n}W"
                if seq[n - 1] != "W" else f"{seq[0]}1W")
    return seq, muts


def _tokens(lengths, seed):
    return [ALPHABET.tokenize(_seq(n, seed + i)) for i, n in enumerate(lengths)]


# ---- host bookkeeping ------------------------------------------------------

def test_constants_and_round_up_match_jax():
    assert tps._KCOL_START_QUANT == jps._KCOL_START_QUANT
    for n, m in [(0, 8), (1, 8), (8, 8), (9, 8), (1023, 32), (1500, 1024)]:
        assert tps._round_up(n, m) == jps._round_up(n, m)


@pytest.mark.parametrize("k", [2, 3, 8])
def test_pack_k_columns_matches_jax(k):
    rng = np.random.default_rng(k)
    items = []
    for a in range(3):
        for sid, start in [(a, 0), (a, 128), (a, 256)][: rng.integers(1, 4)]:
            for off in rng.choice(300, rng.integers(1, 40), replace=False):
                items.append((a, sid, start, off))
    items = np.asarray(items, np.int32)
    got = tps._pack_k_columns(items, k)
    want = jps._pack_k_columns(items, k)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("counts,row_len,max_slots", [
    ({252: 8, 139: 3}, 1024, 28),
    ({74: 40, 120: 33, 252: 17, 711: 5}, 4096, 28),
    ({13: 9, 40: 5, 64: 2}, 64, 4),
])
def test_plan_rows_matches_jax(counts, row_len, max_slots):
    got = tps._plan_rows(counts, row_len, max_slots)
    assert got == jps._plan_rows(counts, row_len, max_slots)
    assert sum(len(r) for r in got) == sum(counts.values())
    assert all(sum(r) <= row_len and len(r) <= max_slots for r in got)
    if counts == {252: 8, 139: 3}:
        assert got[0] == [252, 252, 252, 252]


def test_plan_rows_rejects_an_unplaceable_length():
    with pytest.raises(ValueError, match="exceeds row_len"):
        tps._plan_rows({70: 1}, 64, 4)


# ---- bucketed tables ------------------------------------------------------

def _jax_tables(params, jcfg, toks, **kw):
    return jps.packed_masked_marginal_tables(jesm.make_apply_fn(jcfg), params, toks, **kw)


@pytest.mark.parametrize("lengths,kw", [
    ((11, 19, 13, 30), dict(chunk=4, super_chunks=2, pad_to_multiple=8, window=40)),
    # window 24 forces the optimal-window path for the two long sequences
    ((40, 12, 38), dict(chunk=4, super_chunks=2, pad_to_multiple=8, window=24)),
    ((9, 21, 50), dict(chunk=5, super_chunks=3, buckets=(16, 32), window=48)),
], ids=["short", "long_window", "buckets"])
def test_packed_tables_match_jax(models, lengths, kw):
    params, jcfg, model, _ = models
    toks = _tokens(lengths, sum(lengths))
    want = _jax_tables(params, jcfg, toks, **kw)
    got = tps.packed_masked_marginal_tables(model, toks, **kw)
    for t, g, w in zip(toks, got, want):
        assert g.shape == w.shape == (t.shape[0], len(ALPHABET))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_packed_tables_match_per_assay_tables(models):
    _, _, model, _ = models
    toks = _tokens((14, 40), 5)
    got = tps.packed_masked_marginal_tables(model, toks, chunk=4, super_chunks=2,
                                            pad_to_multiple=8, window=24)
    for t, g in zip(toks, got):
        want = tsc.masked_marginal_table(model, t, chunk=4, window=24, pad_to_multiple=8)
        np.testing.assert_allclose(g, want.numpy(), atol=ATOL, rtol=0)


def test_k_equals_one_matches_default(models):
    _, _, model, _ = models
    toks = _tokens((11, 19), 40)
    kw = dict(chunk=4, super_chunks=2, pad_to_multiple=8, window=40)
    base = tps.packed_masked_marginal_tables(model, toks, **kw)
    k1 = tps.packed_masked_marginal_tables(model, toks, cols_per_forward=1, **kw)
    for b, t in zip(base, k1):
        np.testing.assert_array_equal(t, b)


@pytest.mark.parametrize("k,window", [(2, 40), (4, 24), (3, 300)])
def test_k_column_tables_match_jax(models, k, window):
    # the same forwards on both sides (same grouping, same masked columns),
    # so the k>1 tables agree to float32 noise, not only in rank
    params, jcfg, model, _ = models
    toks = _tokens((11, 30, 40), 60 + k)
    kw = dict(chunk=4, super_chunks=2, pad_to_multiple=8, window=window, cols_per_forward=k)
    want = _jax_tables(params, jcfg, toks, **kw)
    got = tps.packed_masked_marginal_tables(model, toks, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_score_assays_packed_matches_jax(models):
    params, jcfg, model, _ = models
    assays = [_assay(n, s) for n, s in [(14, 7), (22, 8), (14, 9)]]
    kw = dict(chunk=4, super_chunks=2, pad_to_multiple=8, window=40)
    want = jps.score_assays_packed(jesm.make_apply_fn(jcfg), params, assays, **kw)
    got = tps.score_assays_packed(model, assays, **kw)
    for g, w, (_, muts) in zip(got, want, assays):
        assert g.shape == (len(muts),)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)


# ---- segment-packed tables -------------------------------------------------

def _jax_seg_tables(params, jcfg, toks, **kw):
    return jps.packed_segment_tables(jesm.make_segmented_apply_fn(jcfg), params, toks, **kw)


@pytest.mark.parametrize("lengths,kw", [
    # mixed lengths incl. one longer than the window (window path)
    ((13, 21, 9, 40), dict(row_len=64, chunk=2, super_chunks=2, window=32)),
    ((13, 21), dict(row_len=64, chunk=3, super_chunks=1, window=64, max_slots=3)),
    # rows longer than 1024 tokens: the port's attention takes the
    # extent-sparse route (its plain version on the CPU)
    ((300, 190, 75), dict(row_len=1152, chunk=2, super_chunks=2)),
], ids=["row64_window", "row64_slots", "row1152"])
def test_packed_segment_tables_match_jax(models, lengths, kw):
    params, jcfg, model, _ = models
    toks = _tokens(lengths, 4)
    want = _jax_seg_tables(params, jcfg, toks, **kw)
    got = tps.packed_segment_tables(tesm.make_segmented_apply_fn(model), toks, **kw)
    for t, g, w in zip(toks, got, want):
        assert g.shape == w.shape == (t.shape[0], len(ALPHABET))
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


def test_segment_tables_equal_bucketed_tables(models):
    _, _, model, _ = models
    toks = _tokens((13, 21, 9, 40), 4)
    base = tps.packed_masked_marginal_tables(model, toks, chunk=4, super_chunks=2, window=32)
    seg = tps.packed_segment_tables(model, toks, row_len=64, chunk=2, super_chunks=2, window=32)
    for b, s in zip(base, seg):
        np.testing.assert_allclose(s, b, atol=ATOL, rtol=0)


def test_segment_rows_are_built_as_planned():
    # two rows of three slots from two sources; slot 2 of row 1 is empty
    stacked = torch.arange(1, 41).view(2, 20)
    work = torch.tensor([[[0, 1, 0], [1, 1, 0]],      # sids
                         [[0, 5, 0], [2, 0, 0]],      # starts
                         [[0, 4, 7], [0, 6, 0]],      # begins
                         [[4, 3, 2], [6, 5, 0]],      # lens
                         [[1, 0, 1], [5, 2, 0]]])     # offs
    rows, segs, gms = tps._segment_rows(stacked, *work, 12, -1, 0)
    assert rows.tolist() == [[1, -1, 3, 4, -1, 27, 28, 1, -1, 0, 0, 0],
                             [23, 24, 25, 26, 27, -1, 21, 22, -1, 24, 25, 0]]
    assert segs.tolist() == [[1, 1, 1, 1, 2, 2, 2, 3, 3, 0, 0, 0],
                             [1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 0]]
    assert gms.tolist() == [[1, 4, 8], [5, 8, 12]]


@pytest.mark.parametrize("row_len", [64, 1152])
def test_score_assays_packed_segments_match_jax(models, row_len):
    params, jcfg, model, _ = models
    assays = [_assay(n, s) for n, s in [(14, 5), (26, 6)]]
    kw = dict(row_len=row_len, seg_chunk=2, super_chunks=2)
    want = jps.score_assays_packed(
        jesm.make_apply_fn(jcfg), params, assays,
        seg_apply_fn=jesm.make_segmented_apply_fn(jcfg), **kw)
    got = tps.score_assays_packed(model, assays,
                                  seg_apply_fn=tesm.make_segmented_apply_fn(model), **kw)
    for (seq, muts), g, w in zip(assays, got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=0)
        per_assay = tsc.score_assay(model, seq, muts, chunk=8)
        np.testing.assert_allclose(g, per_assay, atol=ATOL, rtol=0)


def test_k_columns_do_not_combine_with_segment_packing(models):
    _, _, model, _ = models
    with pytest.raises(ValueError, match="does not combine"):
        tps.score_assays_packed(model, [_assay(10, 1)], seg_apply_fn=model,
                                cols_per_forward=2)


def test_make_segmented_apply_fn_calls_the_model_with_segments(models):
    _, _, model, _ = models
    toks = torch.from_numpy(ALPHABET.tokenize(_seq(10, 3), pad_to=16)[None]).long()
    seg = torch.tensor([[1] * 12 + [0] * 4], dtype=torch.int32)
    fn = tesm.make_segmented_apply_fn(model)
    torch.testing.assert_close(fn(toks, seg), model(toks, segment_ids=seg), atol=0, rtol=0)


# ---- score --packed through both CLIs --------------------------------------

def _write_world(root, lengths):
    rng = np.random.default_rng(11)
    dms = root / "dms"
    dms.mkdir(parents=True)
    with open(root / "reference.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len"])
        for i, n in enumerate(lengths):
            seq, muts = _assay(n, 20 + i)
            w.writerow([f"P{i}", f"P{i}.csv", f"UP{i}", seq, n])
            with open(dms / f"P{i}.csv", "w", newline="") as g:
                gw = csv.writer(g)
                gw.writerow(["mutant", "DMS_score"])
                gw.writerows([m, f"{rng.standard_normal():.4f}"] for m in muts)
    return root / "reference.csv", dms


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _events(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("extra", [[], ["--extra", "cols_per_forward=2"]], ids=["k1", "k2"])
def test_port_packed_cli_matches_jax_packed_cli(models, tmp_path, extra):
    *_, sd = models
    ref, dms = _write_world(tmp_path, (12, 19))
    ckpt = tmp_path / "esm2_tiny.pt"
    state = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    state["lm_head.weight"] = state["embed_tokens.weight"]
    torch.save({"model": state}, ckpt)
    common = ["--model", "esm", "--checkpoint", f"esm2_tiny:{ckpt}", "--packed",
              "--dms-reference", str(ref), "--dms-dir", str(dms), "--batch-size", "8",
              "--quiet"] + extra
    assert jcli.main(["--platform", "cpu", "score", "--output-dir", str(tmp_path / "jax")]
                     + common) == 0
    assert tcli.main(["score", "--device", "cpu", "--output-dir", str(tmp_path / "torch")]
                     + common) == 0
    for dms_id in ("P0", "P1"):
        want = _read(tmp_path / "jax" / f"{dms_id}.csv")
        got = _read(tmp_path / "torch" / f"{dms_id}.csv")
        assert list(got[0]) == list(want[0]) == ["mutant", "DMS_score", "esm2_tiny_score"]
        assert [r["mutant"] for r in got] == [r["mutant"] for r in want]
        np.testing.assert_allclose([float(r["esm2_tiny_score"]) for r in got],
                                   [float(r["esm2_tiny_score"]) for r in want],
                                   atol=ATOL, rtol=0)
    manifest = [json.loads(line) for line in
                (tmp_path / "torch" / "manifest.jsonl").read_text().splitlines()]
    assert {(m["task"], m["status"]) for m in manifest} == {("esm/P0", "done"),
                                                           ("esm/P1", "done")}
    events = _events(tmp_path / "torch" / "events.jsonl")
    phases = [e for e in events if e.get("phase") == "score_packed"]
    assert [e["event"] for e in phases] == ["phase_start", "phase_end"]
    assert phases[0]["n_assays"] == 2 and phases[0]["n_mutants"] == 26
    thr = [e for e in events if e["event"] == "throughput"]
    assert len(thr) == 1 and thr[0]["label"] == "packed/2" and thr[0]["n_mutants"] == 26


def test_packed_cli_fails_the_batch_as_a_whole(models, tmp_path):
    ref, dms = _write_world(tmp_path, (12, 19))
    with open(dms / "P1.csv", "a", newline="") as f:
        csv.writer(f).writerow(["W999A", "0.0"])  # beyond the sequence
    rc = tcli.main(["score", "--model", "esm", "--checkpoint", "esm2_tiny", "--packed",
                    "--device", "cpu", "--dms-reference", str(ref), "--dms-dir", str(dms),
                    "--output-dir", str(tmp_path / "out"), "--quiet"])
    assert rc == 1
    events = _events(tmp_path / "out" / "events.jsonl")
    assert [e["task"] for e in events if e["event"] == "task_failed"] == ["packed_batch"]
    statuses = {json.loads(line)["status"] for line in
                (tmp_path / "out" / "manifest.jsonl").read_text().splitlines()}
    assert statuses == {"failed"}
    assert not (tmp_path / "out" / "P0.csv").exists()


def test_packed_cli_refuses_other_models_and_ensembles(tmp_path, capsys):
    ref, dms = _write_world(tmp_path, (12,))
    args = ["score", "--packed", "--device", "cpu", "--dms-reference", str(ref),
            "--dms-dir", str(dms), "--output-dir", str(tmp_path / "out"), "--quiet"]
    assert tcli.main(args + ["--model", "poet"]) == 2
    assert "--packed currently supports --model esm" in capsys.readouterr().out
    assert tcli.main(args + ["--model", "esm", "--checkpoint", "esm2_tiny",
                             "--extra", "ensemble=esm2_tiny,esm2_tiny"]) == 1
    failed = [e for e in _events(tmp_path / "out" / "events.jsonl") if e["event"] == "task_failed"]
    assert "ensemble" in failed[-1]["error"]
