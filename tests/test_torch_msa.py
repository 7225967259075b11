"""The port's alignment path (proteingym_tpu_torch.msa and the reference
fields it reads) against the JAX package's: A2M parsing and preprocessing,
neighbour counts, sequence weights, the weights cache both packages share,
and the ``weights`` subcommand.

Counts are compared exactly: they are integers in both packages. On CPU
tensors the port's counts come from its plain version, the comparison the
CUDA kernel is held to on the card (tests/test_torch_cuda_kernels.py).
"""

import csv

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.data.reference import load_reference as jload_reference
from proteingym_tpu.msa import parser as jparser
from proteingym_tpu.msa import weights as jweights
from proteingym_tpu.pipeline import cli as jcli
from proteingym_tpu.pipeline import scorers as jscorers
from proteingym_tpu_torch.data.reference import load_reference as tload_reference
from proteingym_tpu_torch.msa import parser as tparser
from proteingym_tpu_torch.msa import weights as tweights
from proteingym_tpu_torch.pipeline import cli as tcli
from proteingym_tpu_torch.pipeline import scorers as tscorers

AA = "ACDEFGHIKLMNPQRSTVWY"


def _a2m_lines(seed, n=40, length=36):
    """A2M text with a focus row, homologs with substitutions and gaps, four
    insert columns (lowercase letters or '.'), fragments, indeterminate
    letters (X, B) and sequences wrapped over two lines."""
    rng = np.random.default_rng(seed)
    inserts = {5, 6, 20, 31}
    focus = list(rng.choice(list(AA), length))
    rows = [focus]
    for _ in range(n - 1):
        s = list(focus)
        for p in np.nonzero(rng.random(length) < rng.uniform(0.05, 0.5))[0]:
            s[p] = rng.choice(list(AA))
        for p in np.nonzero(rng.random(length) < rng.uniform(0.0, 0.7))[0]:
            s[p] = "-"
        if rng.random() < 0.15:
            s[rng.integers(length)] = rng.choice(["X", "B"])
        rows.append(s)
    lines = []
    for i, s in enumerate(rows):
        s = [c.lower() if p in inserts and c != "-" else ("." if p in inserts else c)
             for p, c in enumerate(s)]
        text = "".join(s)
        lines.append(">FOCUS/3-38" if i == 0 else f">seq{i}/1-{length}")
        lines.extend([text[:20], text[20:]])
    return [line + "\n" for line in lines]


PREPROCESS = {
    "default": {},
    "no_preprocess": {"preprocess": False},
    "keep_indeterminate": {"remove_sequences_with_indeterminate_AA_in_focus_cols": False},
    "focus_col_gap_threshold": {"threshold_focus_cols_frac_gaps": 0.3},
}


@pytest.mark.parametrize("case", sorted(PREPROCESS))
def test_parser_matches_jax(case):
    lines = _a2m_lines(sorted(PREPROCESS).index(case))
    got_parse, want_parse = tparser.parse_a2m(lines), jparser.parse_a2m(lines)
    assert got_parse == want_parse
    names, seqs, focus = got_parse
    got = tparser.preprocess_msa(names, seqs, focus, **PREPROCESS[case])
    want = jparser.preprocess_msa(names, seqs, focus, **PREPROCESS[case])
    assert got.names == want.names
    np.testing.assert_array_equal(got.matrix, want.matrix)
    assert got.matrix.dtype == want.matrix.dtype == np.int8
    np.testing.assert_array_equal(got.focus_cols, want.focus_cols)
    assert (got.focus_seq_name, got.focus_seq_trimmed, got.focus_start, got.focus_stop) == (
        want.focus_seq_name, want.focus_seq_trimmed, want.focus_start, want.focus_stop)
    assert got.sequences() == want.sequences()
    np.testing.assert_array_equal(got.one_hot(), want.one_hot())
    w = np.linspace(0.1, 1.0, got.num_sequences)
    assert got.num_sequences == want.num_sequences
    assert tparser.MSA(**{**got.__dict__, "weights": w}).neff == \
        jparser.MSA(**{**want.__dict__, "weights": w}).neff


def test_encode_and_header_match_jax():
    seqs = ["AC-DE.xz", "acdeFGHI", "-.-.BJOU"]
    np.testing.assert_array_equal(tparser.encode_alignment(seqs), jparser.encode_alignment(seqs))
    for header in (">X/1-20", ">A/B/7-9", ">nospan", ">Y/3-x"):
        assert tparser.parse_focus_header(header) == jparser.parse_focus_header(header)
    with pytest.raises(ValueError, match="ragged"):
        tparser.encode_alignment(["ACD", "AC"])


def _family(seed, n, length, gap_rate=0.05, indeterminate=True):
    """(n, L) int8 codes: clusters of near-identical rows (so counts vary),
    gaps, an all-gap row, duplicated rows and indeterminate codes (21)."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(1, 21, (max(1, n // 6), length))
    m = centres[rng.integers(0, len(centres), n)]
    sub = rng.random((n, length)) < rng.uniform(0.0, 0.12, (n, 1))
    m[sub] = rng.integers(1, 21, sub.sum())
    m[rng.random((n, length)) < gap_rate] = 0
    m[2] = 0
    m[4] = m[5]
    if indeterminate:
        m[6, :3] = 21
    return m.astype(np.int8)


# theta 0.32, L_nongap 25, 17 matches: the float32 rule compares
# 17 > float32(1 - 0.32) * 25, which rounds to 17 (no neighbour); the double
# rule 17/25 = 0.68 > 1 - 0.32 = 0.67999... (a neighbour). A search over
# theta = 0.01..0.99 and L <= 3000 finds such ties at 30 thetas, none at
# ProteinGym's 0.01 and 0.2.
TIE_THETA = 0.32


def _tie_alignment():
    """Row 1 agrees with row 0 at 17 of their 25 columns."""
    base = (np.arange(25) % 20 + 1).astype(np.int8)
    other = base.copy()
    other[:8] = (other[:8] % 20) + 1
    return np.stack([base, other, base[::-1]])


COUNT_CASES = {  # name -> (alignment, theta)
    "clusters": lambda: (_family(0, 50, 23), 0.2),
    "gap_free": lambda: (_family(1, 37, 40, gap_rate=0.0), 0.2),
    "long_rows": lambda: (_family(2, 20, 300), 0.01),  # more than 256 columns
    "threshold_tie": lambda: (_tie_alignment(), TIE_THETA),
}


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_counts_equal_the_jax_pallas_kernel(case):
    m, theta = COUNT_CASES[case]()
    thr = 1.0 - theta
    want = np.asarray(jweights.num_cluster_members_pallas(
        jnp.asarray(m), thr, tile_i=16, tile_j=16, tile_k=128, interpret=True))
    np.testing.assert_array_equal(tweights.num_cluster_members(m, thr).numpy(), want)
    np.testing.assert_array_equal(
        tweights.num_cluster_members(m, thr).numpy(),
        np.asarray(jweights.num_cluster_members(jnp.asarray(m), thr)))
    if case == "clusters":
        assert want.max() > 2 and want[2] == 0  # counts vary; all-gap row 0


def test_threshold_tie_differs_from_the_double_rule():
    # the JAX package's CPU route (native cluster_counts) compares
    # matches / L_nongap > identity in double; the kernels compare in float32
    m = _tie_alignment()
    thr = 1.0 - TIE_THETA
    matches = ((m[:, None, :] == m[None, :, :]) & (m[:, None, :] != 0)).sum(-1)
    double_rule = (matches / (m != 0).sum(1)[:, None] > thr).sum(1)
    f32 = tweights.num_cluster_members(m, thr).numpy()
    assert list(double_rule) == [2, 2, 1] and list(f32) == [1, 1, 1]


@pytest.mark.parametrize("theta", [0.2, 0.01, 0.5])
def test_sequence_weights_equal_jax(theta):
    # no threshold tie at these thetas, and no indeterminate codes (which
    # the native route lets match), so every JAX route agrees with the
    # float32 rule
    m = _family(3, 45, 37, gap_rate=0.05, indeterminate=False)
    want = jweights.sequence_weights(m, theta=theta)
    got = tweights.sequence_weights(m, theta=theta, device="cpu")
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert got[2] == 0.0


def test_sequence_weights_other_devices_raise():
    with pytest.raises(ValueError, match="no sequence-weight path"):
        tweights.sequence_weights(np.ones((2, 3), np.int8), device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tweights.num_cluster_members_cuda(torch.ones(2, 3, dtype=torch.int8), 0.8)


def _write_world(root, n=30, length=36, theta="0.2"):
    (root / "msa").mkdir()
    (root / "msa" / "FAM.a2m").write_text("".join(_a2m_lines(7, n, length)))
    ref = root / "ref.csv"
    with open(ref, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["DMS_id", "DMS_filename", "UniProt_ID", "target_seq", "seq_len",
                    "MSA_filename", "MSA_start", "MSA_end", "MSA_theta", "weight_file_name"])
        w.writerow(["FAM_TEST", "FAM_TEST.csv", "P1", "ACDE", 4, "FAM.a2m", 3, 38, theta,
                    "FAM.npy"])
        w.writerow(["BARE_TEST", "BARE_TEST.csv", "P2", "ACDE", 4, "", "", "", "", ""])
    return ref


def test_reference_msa_fields_match_jax(tmp_path):
    ref = _write_world(tmp_path)
    for got, want in zip(tload_reference(ref), jload_reference(ref)):
        for field in ("DMS_id", "MSA_filename", "MSA_start", "MSA_end", "MSA_theta",
                      "weight_file_name"):
            assert getattr(got, field) == getattr(want, field), field
    rec = tload_reference(ref)["FAM_TEST"]
    assert (rec.MSA_start, rec.MSA_end, rec.MSA_theta) == (3, 38, 0.2)
    assert tload_reference(ref)["BARE_TEST"].MSA_filename is None


def _contexts(root, weights_dir):
    ref = root / "ref.csv"
    trec = tload_reference(ref)["FAM_TEST"]
    jrec = jload_reference(ref)["FAM_TEST"]
    tctx = tscorers.ScoreContext(record=trec, mutants=[], device=torch.device("cpu"),
                                 msa_dir=root / "msa", weights_dir=weights_dir)
    jctx = jscorers.ScoreContext(record=jrec, dms_frame=None, msa_dir=root / "msa",
                                 weights_dir=weights_dir)
    return tctx, jctx


def _refuse(*args, **kwargs):
    raise AssertionError("weights were recomputed instead of read from the cache")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_weights_cache_is_shared_between_packages(tmp_path, monkeypatch, writer):
    _write_world(tmp_path)
    wdir = tmp_path / "weights"
    tctx, jctx = _contexts(tmp_path, wdir)
    first, second = (tctx, jctx) if writer == "port" else (jctx, tctx)
    written = first.load_msa()
    assert (wdir / "FAM.npy").exists()
    cached = np.load(wdir / "FAM.npy")
    assert cached.dtype == np.float64 and len(cached) == written.num_sequences
    monkeypatch.setattr(jweights, "sequence_weights", _refuse)
    monkeypatch.setattr(tweights, "sequence_weights", _refuse)
    read = second.load_msa()
    np.testing.assert_array_equal(read.weights, cached)
    np.testing.assert_array_equal(read.matrix, written.matrix)
    assert read.sequences() == written.sequences()
    assert second.load_msa() is read  # loaded once per context


def test_load_msa_recomputes_a_stale_cache_and_needs_an_msa(tmp_path):
    _write_world(tmp_path)
    wdir = tmp_path / "weights"
    wdir.mkdir()
    np.save(wdir / "FAM.npy", np.ones(3))  # wrong length: recomputed and rewritten
    tctx, _ = _contexts(tmp_path, wdir)
    msa = tctx.load_msa()
    want = jweights.sequence_weights(msa.matrix, theta=0.2)
    np.testing.assert_array_equal(msa.weights, tweights.sequence_weights(msa.matrix, 0.2))
    np.testing.assert_allclose(msa.weights, want, rtol=0, atol=0)
    np.testing.assert_array_equal(np.load(wdir / "FAM.npy"), msa.weights)
    bare = tscorers.ScoreContext(record=tload_reference(tmp_path / "ref.csv")["BARE_TEST"],
                                 mutants=[], device=torch.device("cpu"),
                                 msa_dir=tmp_path / "msa")
    with pytest.raises(FileNotFoundError, match="No MSA"):
        bare.load_msa()


def test_weights_cli_matches_jax_cli(tmp_path, capsys):
    _write_world(tmp_path)
    msa = str(tmp_path / "msa" / "FAM.a2m")
    assert tcli.main(["weights", "--msa", msa, "--theta", "0.2",
                      "--output", str(tmp_path / "t" / "w.npy"), "--device", "cpu"]) == 0
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert jcli.main(["--platform", "cpu", "weights", "--msa", msa, "--theta", "0.2",
                      "--output", str(tmp_path / "j" / "w.npy")]) == 0
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line.split(" -> ")[0] == want_line.split(" -> ")[0]
    assert got_line.startswith("N=") and " Neff=" in got_line
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "w.npy"),
                                  np.load(tmp_path / "j" / "w.npy"))


def test_weights_cli_cuda_without_gpu_raises(tmp_path, monkeypatch):
    _write_world(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["weights", "--msa", str(tmp_path / "msa" / "FAM.a2m"),
                   "--output", str(tmp_path / "w.npy")])
