"""The port's metric kernels (proteingym_tpu_torch.metrics.core, torch in
float64) against the JAX package's (float64: conftest enables x64), scipy
and sklearn, at atol 1e-12; and the bootstrap against the JAX package's,
equal for the same seed."""

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import mannwhitneyu, rankdata, spearmanr
from sklearn.metrics import matthews_corrcoef, roc_auc_score

jax = pytest.importorskip("jax")

from proteingym_tpu.metrics import bootstrap as jboot
from proteingym_tpu.metrics import core as jcore
from proteingym_tpu_torch.metrics import bootstrap as tboot
from proteingym_tpu_torch.metrics import core as tcore

ATOL = 1e-12
FUNCS = ["spearman", "auc", "mcc", "ndcg", "top_k_recall"]


def _pair(name):
    return getattr(jcore, name), getattr(tcore, name)


def _inputs(kind, n, seed):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=n)
    s = 0.4 * y + rng.normal(size=n)
    if kind == "ties":
        y, s = np.round(y * 2) / 2, np.round(s * 3) / 3
    b = (y > np.median(y)).astype(float)
    valid = np.ones(n, dtype=bool)
    if kind == "masked":
        valid[rng.choice(n, n // 4, replace=False)] = False
    if kind == "nan_scores":
        s[rng.choice(n, n // 5, replace=False)] = np.nan
        valid = np.isfinite(s)
    return y, b, s, valid


def _first_arg(name, y, b):
    return b if name in ("auc", "mcc") else y


@pytest.mark.parametrize("kind", ["plain", "ties", "masked", "nan_scores"])
@pytest.mark.parametrize("name", FUNCS)
def test_metric_matches_jax(name, kind):
    jf, tf = _pair(name)
    y, b, s, valid = _inputs(kind, 301, FUNCS.index(name))
    a = _first_arg(name, y, b)
    want = float(jf(a, s, valid))
    got = tf(a, s, valid)
    assert got.dtype == torch.float64 and got.shape == ()
    assert float(got) == pytest.approx(want, abs=ATOL, nan_ok=True)


def test_average_rank_matches_scipy_and_jax():
    x = np.random.default_rng(0).integers(0, 10, size=200).astype(float)
    got = tcore.average_rank(x).numpy()
    np.testing.assert_array_equal(got, rankdata(x))
    np.testing.assert_array_equal(got, np.asarray(jcore.average_rank(x)))


@pytest.mark.parametrize("with_ties", [False, True])
def test_spearman_auc_mcc_match_scipy_and_sklearn(with_ties):
    rng = np.random.default_rng(4)
    n = 500
    b = rng.integers(0, 2, size=n)
    s = rng.integers(0, 20, size=n).astype(float) if with_ties else rng.normal(size=n)
    y = s + rng.normal(size=n)
    assert float(tcore.spearman(y, s)) == pytest.approx(spearmanr(y, s)[0], abs=ATOL)
    assert float(tcore.auc(b, s)) == pytest.approx(roc_auc_score(b, s), abs=ATOL)
    u = mannwhitneyu(s[b == 1], s[b == 0]).statistic
    assert float(tcore.auc(b, s)) == pytest.approx(u / ((b == 1).sum() * (b == 0).sum()), abs=ATOL)
    pred = (s >= np.median(s)).astype(int)
    assert float(tcore.mcc(b, s)) == pytest.approx(matthews_corrcoef(b, pred), abs=ATOL)


def test_edge_values():
    s = np.random.default_rng(1).normal(size=50)
    assert np.isnan(float(tcore.auc(np.ones(50), s)))  # one class
    assert np.isnan(float(tcore.auc(np.zeros(50), s)))
    assert float(tcore.mcc(np.ones(4), np.ones(4))) == 0.0  # degenerate
    assert np.isnan(float(tcore.mcc(np.full(64, np.nan), s[:1].repeat(64))))  # all-NaN labels
    y = np.array([0.0] * 9 + [1.0] + [0.0] * 9 + [1.0])
    assert float(tcore.ndcg(y, -y)) == 0.0 == float(jcore.ndcg(y, -y))  # no top hits
    for name in FUNCS:
        jf, tf = _pair(name)
        got, want = float(tf(y, -y)), float(jf(y, -y))
        assert got == pytest.approx(want, abs=ATOL, nan_ok=True), name


def test_padded_equals_unpadded_and_batched_equals_per_assay():
    rng = np.random.default_rng(7)
    lengths = [100, 37, 256, 5]
    width = 300
    rows = {k: np.zeros((len(lengths), width)) for k in ("y", "b", "s")}
    valid = np.zeros((len(lengths), width), dtype=bool)
    singles = []
    for i, n in enumerate(lengths):
        y, b, s, _ = _inputs("ties" if i % 2 else "plain", n, 10 + i)
        rows["y"][i, :n], rows["b"][i, :n], rows["s"][i, :n] = y, b, s
        rows["y"][i, n:] = rng.normal(size=width - n)  # junk in the padding
        valid[i, :n] = True
        singles.append(tcore.assay_metrics_host(y, b, s))
        jax_one = jcore.assay_metrics_host(y, b, s)
        for m in jax_one:
            assert singles[-1][m] == pytest.approx(jax_one[m], abs=ATOL, nan_ok=True), (n, m)
    out = tcore.metrics_to_numpy(
        tcore.batched_assay_metrics(rows["y"], rows["b"], rows["s"], valid))
    jout = jcore.batched_assay_metrics(rows["y"], rows["b"], rows["s"], valid)
    for m, col in out.items():
        assert col.shape == (len(lengths),)
        np.testing.assert_allclose(col, [one[m] for one in singles], atol=ATOL, rtol=0)
        np.testing.assert_allclose(col, np.asarray(jout[m]), atol=ATOL, rtol=0)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        tcore.batched_assay_metrics(rows["y"][0], rows["b"][0], rows["s"][0], valid[0])


def test_large_assay_counts_do_not_overflow():
    rs = np.random.RandomState(0)
    n = 200_000
    y = rs.randint(0, 2, n).astype(np.float64)
    s = y + rs.normal(0, 5, n)
    got = tcore.assay_metrics_host(s + rs.normal(size=n), y, s)
    assert got["AUC"] == pytest.approx(roc_auc_score(y, s), abs=ATOL)
    pred = (s >= np.median(s)).astype(int)
    assert got["MCC"] == pytest.approx(matthews_corrcoef(y, pred), abs=ATOL)


def test_bootstrap_equals_jax():
    rng = np.random.default_rng(3)
    values = rng.normal(size=(23, 4))
    values[2, 1] = np.nan
    values[:, 3] = np.nan  # an all-NaN model column
    frame = pd.DataFrame(values, columns=["a", "b", "c", "d"])
    want = jboot.bootstrap_standard_error(frame, number_assay_reshuffle=500, seed=5)
    got = tboot.bootstrap_standard_error(values, number_assay_reshuffle=500, seed=5)
    np.testing.assert_array_equal(got, want.to_numpy())

    cats = np.asarray(["Stability", "Activity", "Binding"] * 7 + ["Activity", "Stability"],
                      dtype=object)
    frame.index = pd.MultiIndex.from_arrays([[f"U{i}" for i in range(23)], cats],
                                            names=["UniProt_ID", "Selection Type"])
    want = jboot.bootstrap_standard_error_functional_categories(
        frame, number_assay_reshuffle=400, seed=0)
    got = tboot.bootstrap_standard_error_functional_categories(
        values, cats, number_assay_reshuffle=400, seed=0)
    np.testing.assert_array_equal(got, want.to_numpy())


def test_nan_measurements_rank_as_in_an_unpadded_call():
    """A NaN DMS score ranks above every number in an unpadded JAX call;
    padding slots must not change that (torch's searchsorted has no NaN
    order of its own)."""
    y, b, s, _ = _inputs("plain", 120, 21)
    y[[4, 50]] = np.nan
    want = jcore.assay_metrics_host(y, b, s)
    valid = np.zeros((1, 200), dtype=bool)
    valid[0, :120] = True
    pad = lambda a: np.pad(a, (0, 80), constant_values=3.0)[None, :]  # noqa: E731
    got = tcore.metrics_to_numpy(tcore.batched_assay_metrics(pad(y), pad(b), pad(s), valid))
    for m, v in want.items():
        assert float(got[m][0]) == pytest.approx(v, abs=ATOL, nan_ok=True), m
    np.testing.assert_array_equal(tcore.average_rank(y).numpy(), np.asarray(jcore.average_rank(y)))
