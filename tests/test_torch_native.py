"""The port's host library (proteingym_tpu_torch.native, its own copies of
the Gotoh recursion and of the neighbour-joining tree, built with g++ at
first use) against the JAX package's native library: equal alignments,
column for column, on seeded random pairs and the edge cases of indel
realignment, pair by pair and in one batch on native threads; equal NJ
trees (children and both branch lengths, exactly) on alignments with
duplicated and all-gap rows from 2 to 1,024 rows; the libraries' hashed
names under _build/; and a failed build raises (no fallback aligner and
no fallback tree)."""

from pathlib import Path

import numpy as np
import pytest

from proteingym_tpu import native as jnative
from proteingym_tpu_torch import native as tnative

REPO = Path(__file__).resolve().parent.parent

def _assert_same(a, b, **kw):
    got = tnative.affine_align(a, b, **kw)
    want = jnative.affine_align(a, b, **kw)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == got[2].dtype == np.int32
    return got


def _indel_pair(rs, n):
    """A random reference and a copy with substitutions, deletions and
    insertions of 1-4 residues anywhere, ends included; 0 codes (gaps or
    non-amino acids) sprinkled in."""
    a = rs.randint(0, 21, n).astype(np.int8)
    b = a.copy()
    for _ in range(rs.randint(0, 4)):
        kind, at, size = rs.randint(3), rs.randint(0, len(b) + 1), rs.randint(1, 5)
        if kind == 0 and len(b):
            b[rs.randint(len(b))] = rs.randint(1, 21)
        elif kind == 1:
            b = np.delete(b, np.arange(at, min(at + size, len(b))))
        else:
            b = np.insert(b, at, rs.randint(1, 21, size))
    return a, b.astype(np.int8)


@pytest.mark.parametrize("seed", range(4))
def test_random_pairs_equal_jax(seed):
    rs = np.random.RandomState(seed)
    for _ in range(60):  # 240 pairs in all
        a, b = _indel_pair(rs, rs.randint(1, 80))
        _assert_same(a, b)
        _assert_same(b, a)


@pytest.mark.parametrize("ref_len", [60, 7, 1])
def test_batch_equals_jax_pair_by_pair(ref_len):
    # one reference against many queries (more than the CPUs, so the
    # threads share them out), empty and length-1 ones among them
    rs = np.random.RandomState(10 + ref_len)
    ref = rs.randint(0, 21, ref_len).astype(np.int8)
    queries = [_indel_pair(rs, ref_len)[1] for _ in range(200)]
    queries[5:5] = [ref[:0], ref[:1], ref.copy()]
    got = tnative.affine_align_many(ref, queries)
    assert len(got) == len(queries)
    for (alen, a_cols, b_cols), q in zip(got, queries):
        want = jnative.affine_align(ref, q)
        assert alen == want[0]
        np.testing.assert_array_equal(a_cols, want[1])
        np.testing.assert_array_equal(b_cols, want[2])
    assert tnative.affine_align_many(ref, []) == []


def _codes(s):
    return np.asarray(["-ACDEFGHIKLMNPQRSTVWY".index(c) for c in s], dtype=np.int8)


@pytest.mark.parametrize("a,b", [
    ("ACDEFGHIKL", "ACDEFGHIKL"),          # identical
    ("ACDEFGHIKL", "ACDQFGHIWL"),          # substitutions only
    ("ACDEFGHIKL", "ACDFGHIKL"),           # one deletion
    ("ACDEFGHIKL", "ACDGHIKL"),            # two
    ("ACDEFGHIKL", "ACDEWFGHIKL"),         # one insertion
    ("ACDEFGHIKL", "ACDEWWWFGHIKL"),       # three
    ("ACDEFGHIKL", "CDEFGHIKL"),           # deletion at the start
    ("ACDEFGHIKL", "ACDEFGHIK"),           # at the end
    ("ACDEFGHIKL", "MMACDEFGHIKL"),        # insertion at the start
    ("ACDEFGHIKL", "ACDEFGHIKLMM"),        # at the end
    ("AAAAAAAA", "AAAAAAA"),               # ties: which A is deleted
    ("GAAAG", "GAAAAAG"),                  # ties: where the inserted A goes
    ("A", "ACDE"), ("ACDE", "A"),          # a length-1 side
    ("", "ACD"), ("ACD", ""), ("", ""),    # an empty side
    ("A-C-D", "ACD"),                      # gap codes never match
])
def test_edge_cases_equal_jax(a, b):
    alen, a_cols, b_cols = _assert_same(_codes(a), _codes(b))
    assert alen >= max(len(a), len(b))
    assert (a_cols >= 0).all() and (b_cols >= 0).all()  # every residue has its column


@pytest.mark.parametrize("scores", [dict(match=5, mismatch=-4, gap_open=-10, gap_extend=-1),
                                    dict(match=200, mismatch=-300, gap_open=-100,
                                         gap_extend=-100)])
def test_other_scores_equal_jax(scores):
    rs = np.random.RandomState(9)
    for _ in range(20):
        _assert_same(*_indel_pair(rs, rs.randint(1, 50)), **scores)


def test_library_lands_in_build_under_a_hashed_name():
    tnative.affine_align(_codes("ACD"), _codes("AD"))
    path = tnative.library_path()
    assert path.parent == REPO / "proteingym_tpu_torch" / "_build"
    assert path.name.startswith("libpgym_align_") and path.suffix == ".so"
    assert len(path.stem.split("_")[-1]) == 16 and path.exists()


def _nj_alignment(rs, n, length):
    focus = rs.randint(1, 21, length)
    m = np.tile(focus, (n, 1))
    sub = rs.rand(n, length) < rs.uniform(0.05, 0.6, n)[:, None]
    m[sub] = rs.randint(1, 21, sub.sum())
    m[rs.rand(n, length) < 0.15] = 0
    if n > 3:
        m[1] = 0                   # an all-gap row: distance 1 to every row
        m[2] = m[3]                # a duplicate: distance 0, ties in Q
        m[rs.randint(n, size=n // 4)] = m[rs.randint(n, size=n // 4)]
    return m.astype(np.int8)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 64, 512, 1024])
def test_nj_tree_equals_jax(n):
    for seed in range(3 if n < 1024 else 1):
        rs = np.random.RandomState(100 * seed + n)
        m = _nj_alignment(rs, n, 240 if n == 1024 else 60)
        got = tnative.nj_tree(m)
        want = jnative.nj_tree(m)
        assert [a.dtype for a in got] == [np.int32, np.int32, np.float64, np.float64]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)  # the branch lengths too, bit for bit
        # a tree: every node but the root is a child exactly once
        children = np.sort(np.concatenate([got[0], got[1]]))
        np.testing.assert_array_equal(children, np.arange(2 * n - 2))


def test_nj_tree_of_identical_rows_breaks_ties_as_jax():
    m = np.tile(np.arange(1, 21, dtype=np.int8), (40, 1))
    m[::7] = 0
    for g, w in zip(tnative.nj_tree(m), jnative.nj_tree(m)):
        np.testing.assert_array_equal(g, w)


def test_nj_tree_of_fewer_than_two_rows_raises():
    with pytest.raises(ValueError, match=">= 2 rows"):
        tnative.nj_tree(np.ones((1, 5), np.int8))


def test_nj_library_lands_in_build_under_a_hashed_name():
    tnative.nj_tree(np.ones((3, 4), np.int8))
    path = tnative.library_path(tnative.NJ_SOURCE)
    assert path.parent == REPO / "proteingym_tpu_torch" / "_build"
    assert path.name.startswith("libpgym_nj_") and path.exists()
    assert path != tnative.library_path()
    assert "-ffp-contract=off" in tnative.CXX_FLAGS and "-march=native" not in tnative.CXX_FLAGS


def test_a_failed_nj_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_nj_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnative.nj_tree(np.ones((3, 4), np.int8))
    assert tnative._nj_lib is None


def test_a_library_without_the_symbol_raises(tmp_path, monkeypatch):
    # a library built from another source (here the aligner's) under the
    # tree's name: loading it raises, it is never used in its place
    monkeypatch.setattr(tnative, "_nj_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    tnative._build(tnative.SOURCE, tnative.library_path(tnative.NJ_SOURCE))
    with pytest.raises(AttributeError, match="pgym_nj_tree"):
        tnative.nj_tree(np.ones((3, 4), np.int8))
    assert tnative._nj_lib is None


def test_a_failed_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnative.affine_align(_codes("ACD"), _codes("AD"))
    # a compiler that runs and fails: its stderr is in the error
    fake = tmp_path / "failing-cxx"
    fake.write_text("#!/bin/sh\necho 'error: no luck' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(tnative, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="no luck"):
        tnative.affine_align(_codes("ACD"), _codes("AD"))
    assert tnative._lib is None and not list((tmp_path / "build").glob("*.so"))



def _filter_world(case):
    """(matrix, options) for an hhfilter case: seeded codes 0..20 with rows
    copied, gapped and mutated so every branch of the filter is taken."""
    rs = np.random.RandomState(case)
    n, length = (1, 12) if case == 5 else (60, 40)
    m = rs.randint(1, 21, (n, length)).astype(np.int8)
    for i in range(1, n):
        if i % 3 == 0:  # near copies of row 0 (identity above 0.9 or not)
            m[i] = m[0]
            m[i, rs.choice(length, rs.randint(0, 8), replace=False)] = rs.randint(1, 21)
        if i % 4 == 1:  # gappy rows (coverage below 0.75 or not)
            m[i, rs.choice(length, rs.randint(5, 25), replace=False)] = 0
    m[n // 2:n // 2 + 2] = m[n // 2 - 1]  # exact duplicates
    options = [dict(), dict(min_coverage=0.5, max_identity=0.8),
               dict(min_query_identity=0.3), dict(max_identity=1.0, min_coverage=0.0),
               dict(min_coverage=0.9, max_identity=0.95, min_query_identity=0.1), dict()][case]
    return m, options


@pytest.mark.parametrize("case", range(6))
def test_hhfilter_mask_equals_jax(case):
    m, options = _filter_world(case)
    got = tnative.hhfilter_mask(m, **options)
    want = jnative.hhfilter_mask(m, **options)
    assert got.dtype == bool and got.shape == (m.shape[0],)
    np.testing.assert_array_equal(got, want)
    assert got[0]


def test_hhfilter_builds_its_own_library(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_hhfilter_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    tnative.hhfilter_mask(np.ones((3, 4), np.int8))
    path = tnative.library_path(tnative.HHFILTER_SOURCE)
    assert path.exists() and path.parent == tmp_path / "build"
    assert path not in (tnative.library_path(), tnative.library_path(tnative.NJ_SOURCE))
    monkeypatch.setattr(tnative, "_hhfilter_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "other")
    monkeypatch.setattr(tnative, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        tnative.hhfilter_mask(np.ones((3, 4), np.int8))
