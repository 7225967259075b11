"""The port's aligner (proteingym_tpu_torch.native, its own copy of the
Gotoh recursion built with g++ at first use) against the JAX package's
native library: equal alignments, column for column, on seeded random
pairs and the edge cases of indel realignment, pair by pair and in one
batch on native threads; the library's hashed name
under _build/; and a failed build raises (no fallback aligner)."""

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

