"""The port's PROVEAN (proteingym_tpu_torch.models.provean) against the
JAX package's: the score-only Gotoh scores equal exactly (every cell is a
small integer) on substitutions, indels, subjects of many lengths padded
to 32 and the edge cases; the supporting set list for list; the scores;
and the ``provean`` scorer through both CLIs on substitutions and on
whole indel sequences."""

import numpy as np
import pytest

pytest.importorskip("jax")

from proteingym_tpu.models import provean as jprovean
from proteingym_tpu_torch.models import provean as tprovean

from test_torch_gemme import run_clis, score_column, write_baseline_world

AA = "ACDEFGHIKLMNPQRSTVWY"


def _seq(rs, n, alphabet=AA):
    return "".join(alphabet[i] for i in rs.randint(0, len(alphabet), n))


def _variants(rs, wt, n):
    out = []
    for i in range(n):
        s = list(wt)
        at = rs.randint(0, len(s))
        if i % 3 == 0:
            s[at] = AA[(AA.index(s[at]) + 1 + rs.randint(19)) % 20]
        elif i % 3 == 1:
            del s[at:at + rs.randint(1, 4)]
        else:
            s[at:at] = list(_seq(rs, rs.randint(1, 4)))
        out.append("".join(s))
    return out


@pytest.mark.parametrize("gaps", [(10.0, 1.0), (11.0, 2.0), (3.0, 3.0)])
def test_align_scores_equal_jax(gaps):
    rs = np.random.RandomState(int(sum(gaps)))
    wt = _seq(rs, 37)
    subjects = [_seq(rs, n) for n in (1, 5, 31, 32, 33, 36, 37, 64, 65, 90)]
    subjects += _variants(rs, wt, 12) + [wt, "BZX*" + wt[4:], "ACDU" * 9]  # odd letters
    got = tprovean.align_scores([wt] * len(subjects), subjects, *gaps, device="cpu")
    want = jprovean.align_scores([wt] * len(subjects), subjects, *gaps)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # each query against each subject (indels: queries of other lengths)
    for q in _variants(rs, wt, 6):
        np.testing.assert_array_equal(
            tprovean.align_scores([q] * len(subjects), subjects, *gaps, device="cpu"),
            jprovean.align_scores([q] * len(subjects), subjects, *gaps))


def test_padding_never_reaches_a_score():
    rs = np.random.RandomState(5)
    wt, s = _seq(rs, 20), _seq(rs, 25)
    alone = tprovean.align_scores([wt], [s], device="cpu")
    for pad_to in (1, 32, 128):  # padded with code 0 (A) to other lengths
        np.testing.assert_array_equal(
            tprovean.align_scores([wt, wt], [s, _seq(rs, 70)], pad_to=pad_to,
                                  device="cpu")[:1], alone)


def test_cluster_supporting_set_equals_jax():
    rs = np.random.RandomState(2)
    wt = _seq(rs, 60)
    homologs = [wt, wt.lower(), "--" + wt[2:], "", "-" * 10, wt[:2]]
    for i in range(300):
        s = list(wt)
        for _ in range(rs.randint(0, 30)):
            s[rs.randint(60)] = AA[rs.randint(20)]
        if i % 7 == 0:
            s = s[: rs.randint(1, 60)]
        homologs.append("".join(c if rs.rand() > 0.05 else "." for c in s))
    for kw in ({}, dict(max_candidates=1000), dict(max_clusters=3, seed=4),
               dict(identity=0.5, max_candidates=50)):
        got = tprovean.cluster_supporting_set(wt, homologs, **kw)
        assert got == jprovean.cluster_supporting_set(wt, homologs, **kw)
    assert len(got) > 3


@pytest.mark.parametrize("max_per_cluster", [1, 5])
def test_provean_scores_equal_jax(max_per_cluster):
    rs = np.random.RandomState(7)
    wt = _seq(rs, 45)
    homologs = [wt] + ["".join(AA[rs.randint(20)] if rs.rand() < 0.3 else c for c in wt)
                       for _ in range(80)]
    clusters = tprovean.cluster_supporting_set(wt, homologs, max_candidates=60)
    variants = _variants(rs, wt, 40) + [wt]
    got = tprovean.provean_scores(wt, variants, clusters, max_per_cluster=max_per_cluster,
                                  device="cpu")
    want = jprovean.provean_scores(wt, variants, clusters, max_per_cluster=max_per_cluster)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == 0.0
    assert (tprovean.provean_scores(wt, variants, [], device="cpu") == 0).all()


def test_provean_scores_in_small_calls_equal_one_call(monkeypatch):
    rs = np.random.RandomState(8)
    wt = _seq(rs, 30)
    clusters = [[_seq(rs, 28), _seq(rs, 33)], [_seq(rs, 30)], [_seq(rs, 40)]]
    variants = _variants(rs, wt, 25)
    whole = tprovean.provean_scores(wt, variants, clusters, device="cpu")
    monkeypatch.setattr(tprovean, "PAIR_CELLS", 100)  # one variant per call
    np.testing.assert_array_equal(tprovean.provean_scores(wt, variants, clusters, device="cpu"),
                                  whole)


@pytest.mark.parametrize("indel", [False, True])
def test_provean_scorer_writes_the_jax_cli_file(tmp_path, indel):
    target, _ = write_baseline_world(tmp_path, n_rows=300, seed=6, indel=indel)
    port, want = run_clis(tmp_path, "provean", indel=indel,
                          extra=["max_candidates=60", "max_clusters=8"])
    assert port[0] == want[0] and port[0][-1] == "Provean_score"
    assert port == want  # every field, the scores included, written the same
    got = score_column(port)
    assert np.isfinite(got).all() and len(set(got)) > 5
    if indel:
        assert port[-1][0] == target and got[-1] == 0.0
