"""The supervised ridges in the port against the JAX package on the CPU:
the CV folds equal, the float32 Cholesky ridge's out-of-fold predictions,
the mean-pooled ESM embedding features (one fair-esm state dict on both
sides), the zero-shot join, and a whole assay through
``run_supervised_baseline``. The JAX side runs inside
``jax.enable_x64(False)``."""

import warnings
from unittest import mock

import numpy as np
import pandas as pd
import pytest
import torch

jax = pytest.importorskip("jax")

from proteingym_tpu.models import esm2 as jesm  # noqa: E402
from proteingym_tpu.models import supervised_baselines as jsb  # noqa: E402
from proteingym_tpu_torch.data.table import Table  # noqa: E402
from proteingym_tpu_torch.models import esm2 as tesm  # noqa: E402
from proteingym_tpu_torch.models import supervised_baselines as tsb  # noqa: E402
from tests.test_torch_esm2 import fair_esm_state  # noqa: E402
from tests.test_torch_eve_train import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

AA = "ACDEFGHIKLMNPQRSTVWY"
# float32 Cholesky solves of a (features + 1)-wide Gram, LAPACK in both but
# blocked differently: predictions of O(1) agree to ~1e-5; the planted
# fault (lam left out of the Gram) moves them by O(0.1)
RIDGE_ATOL = 2e-4
# mean-pooled float32 embeddings through 2 layers (summation order only)
EMB_ATOL = 1e-5


def assay(length=24, n=150, seed=0, aux=False):
    rs = np.random.RandomState(seed)
    seq = "".join(rs.choice(list(AA), length))
    muts = set()
    while len(muts) < n:
        k = rs.randint(1, 3)
        pos = sorted(rs.choice(length, k, replace=False))
        muts.add(":".join(f"{seq[p]}{p + 1}{rs.choice([a for a in AA if a != seq[p]])}"
                          for p in pos))
    muts = sorted(muts)
    seqs = []
    for m in muts:
        s = list(seq)
        for tok in m.split(":"):
            s[int(tok[1:-1]) - 1] = tok[-1]
        seqs.append("".join(s))
    frame = pd.DataFrame({"mutant": muts, "mutated_sequence": seqs,
                          "DMS_score": rs.randn(n)})
    if aux:
        z = rs.randn(n)
        z[[3, 17]] = np.nan
        frame["zero_shot_score"] = z
    return seq, frame


def as_table(frame):
    t = Table(n_rows=len(frame))
    for c in frame.columns:
        col = frame[c].to_numpy()
        t[c] = col.astype(object) if col.dtype == object else col
    return t


@pytest.mark.parametrize("scheme", tsb.CV_SCHEMES)
def test_folds_equal_jax(scheme):
    _, frame = assay(n=200, seed=1)
    muts = frame["mutant"].tolist()
    np.testing.assert_array_equal(tsb.assign_folds(muts, scheme), jsb.assign_folds(muts, scheme))


def test_ridge_matches_jax():
    seq, frame = assay(seed=2)
    x = tsb.onehot_features(frame["mutated_sequence"], len(seq))
    np.testing.assert_array_equal(x, jsb.onehot_features(frame["mutated_sequence"], len(seq)))
    y = frame["DMS_score"].to_numpy()
    folds = np.arange(len(y)) % 5  # folds of one size: the JAX solve compiles once
    with jax.enable_x64(False):
        want = jsb.ridge_cv_predict(x, y, folds, lam=0.5)
    got = tsb.ridge_cv_predict(x, y, folds, lam=0.5, device="cpu")
    np.testing.assert_allclose(got, want, atol=RIDGE_ATOL, rtol=0)
    bad = tsb.ridge_cv_predict(x, y, folds, lam=1e-3, device="cpu")  # lam almost dropped
    assert np.abs(bad - want).max() > 10 * RIDGE_ATOL


def test_embedding_features_match_jax():
    sd = fair_esm_state(tesm.PRESETS["esm2_tiny"], seed=4)
    with jax.enable_x64(False):
        params = jesm.convert_torch_state_dict(sd, jesm.PRESETS["esm2_tiny"])
    model = tesm.load_fair_esm_state_dict(sd, tesm.PRESETS["esm2_tiny"], device="cpu")
    seqs = ["MKTAYIAK", "MKTAYIAKQRQ", "MKTAY", "MKTAYIAKQRQISFV", "MKTW"]
    with jax.enable_x64(False):
        want = jsb.esm_embedding_features(params, jesm.PRESETS["esm2_tiny"], seqs, batch_size=2)
    got = tsb.esm_embedding_features(model, seqs, batch_size=2)
    assert got.shape == (5, tesm.PRESETS["esm2_tiny"].embed_dim)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL, rtol=0)
    # the padding counted in the mean (BOS/EOS are in it; padding is not) fails
    with mock.patch.object(tsb, "mean_pool", lambda final, tokens, pad: final.mean(1)):
        bad = tsb.esm_embedding_features(model, seqs, batch_size=2)
    assert np.abs(bad - want).max() > 10 * EMB_ATOL


def test_aug_scores_join_equal_jax(tmp_path):
    _, frame = assay(seed=5)
    muts = frame["mutant"].tolist()
    rs = np.random.RandomState(6)
    scores = pd.DataFrame({"mutant": muts[:100] + muts[:10] + ["X1Y"],
                           "DMS_score": rs.randn(111), "zs": rs.randn(111),
                           "other": rs.randn(111)})
    scores.to_csv(tmp_path / "s.csv", index=False)
    for col in (None, "zs"):
        want = jsb.load_aug_scores(frame, tmp_path / "s.csv", col)
        got = tsb.load_aug_scores(muts, tmp_path / "s.csv", col)
        np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
        assert np.isnan(got[100:]).all() and np.isfinite(got[:100]).all()
    pd.DataFrame({"mutant": ["Q9W"], "zs": [1.0]}).to_csv(tmp_path / "none.csv", index=False)
    with pytest.raises(ValueError, match="no mutants matched"):
        tsb.load_aug_scores(muts, tmp_path / "none.csv")


@pytest.mark.parametrize("augmented", [False, True], ids=["ohe", "ohe_aug"])
def test_run_supervised_baseline_matches_jax(augmented):
    seq, frame = assay(seed=7, aux=augmented)
    # published fold columns, every fold of one size (the JAX solve compiles
    # once); assign_folds's own folds are test_folds_equal_jax's
    for scheme in tsb.CV_SCHEMES:
        frame[scheme] = np.random.RandomState(len(scheme)).permutation(len(frame)) % 5
    aux = frame["zero_shot_score"].to_numpy() if augmented else None
    with jax.enable_x64(False), warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = jsb.run_supervised_baseline(frame, seq, aux=aux)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = tsb.run_supervised_baseline(as_table(frame), seq, aux=aux, device="cpu")
    nan_fill = lambda ws: [str(w.message) for w in ws if "NaN" in str(w.message)]  # noqa: E731
    assert nan_fill(tw) == nan_fill(jw) and len(nan_fill(tw)) == augmented
    assert list(got) == list(want) == tsb.CV_SCHEMES
    for scheme in got:
        assert got[scheme].names == list(want[scheme].columns)
        assert got[scheme]["mutant"].tolist() == want[scheme]["mutant"].tolist()
        np.testing.assert_allclose(got[scheme]["y_pred"], want[scheme]["y_pred"],
                                   atol=RIDGE_ATOL, rtol=0)
