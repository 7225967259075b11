"""Kermut in the port against the JAX package on the CPU, float32 on both
sides (the JAX side inside ``jax.enable_x64(False)``, as its CLI runs):
the Gram through the (L, L) distance gather on multi-mutants, the negative
log marginal likelihood, ``fit`` run for run, ``predict``, and the
ProteinMPNN conditionals (one weight set through ``params_from_jax``)."""

from unittest import mock

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from proteingym_tpu.models import kermut as jk  # noqa: E402
from proteingym_tpu.models import protein_mpnn as jm  # noqa: E402
from proteingym_tpu_torch.data.structures import synthetic_helix_backbone  # noqa: E402
from proteingym_tpu_torch.models import kermut as tk  # noqa: E402
from proteingym_tpu_torch.models import protein_mpnn as tm  # noqa: E402
from tests.test_torch_eve_train import one_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_thread")

AA = "ACDEFGHIKLMNPQRSTVWY"
# float32 Gram entries of O(1-10): the same formulas, exp and sums in
# another order (~1e-6 relative); dropping the distance term (the planted
# fault) moves them by O(1)
GRAM_RTOL = 1e-5
# the NLL's float32 Cholesky of an n=40 Gram: ~1e-5 of its O(100) value
NLL_ATOL = 1e-3
# 20 Adam steps at lr 0.1 on float32 gradients through a Cholesky: the
# hyperparameters follow the same path to ~1e-4
FIT_ATOL = 1e-3
PRED_ATOL = 1e-3
# MPNN conditionals, float32 through 3 + 3 layers
PROBS_ATOL = 1e-5


def world(length=30, n=60, seed=0, max_depth=3):
    rs = np.random.RandomState(seed)
    seq = "".join(rs.choice(list(AA), length))
    muts = []
    for i in range(n):
        k = 1 + i % max_depth
        pos = sorted(rs.choice(length, k, replace=False))
        muts.append(":".join(f"{seq[p]}{p + 1}{rs.choice(list(AA))}" for p in pos))
    muts[5] = ""  # a WT row: no valid mutation
    probs = rs.dirichlet(np.ones(20) * 0.5, length)
    coords = synthetic_helix_backbone(length, seed=seed)
    coords[:, 1] += 0.3 * rs.randn(length, 3)
    y = rs.randn(n)
    return seq, muts, tk.KermutData.build(probs, coords[:, 1]), y


def _jhypers(h):
    return {k: jnp.asarray(float(v), jnp.float32) for k, v in h.items()}


def test_distance_gather_equals_the_jax_difference():
    _, muts, data, _ = world()
    enc = tk.encode_variants(muts)
    tables = tk.DeviceTables(data, "cpu")
    pa = torch.as_tensor(enc[0]).long()
    got = tables.distance[pa][:, :, pa].numpy()
    with jax.enable_x64(False):
        coords = jnp.asarray(data.coords)
        want = np.asarray(jnp.linalg.norm(
            coords[enc[0]][:, :, None, None, :] - coords[enc[0]][None, None, :, :, :], axis=-1))
    np.testing.assert_array_equal(got, want)  # the same norms of the same float32 vectors


@pytest.mark.parametrize("with_emb", [False, True], ids=["mutation", "with_rbf"])
def test_gram_matches_jax(with_emb):
    _, muts, data, _ = world(seed=1)
    enc = tk.encode_variants(muts)
    rs = np.random.RandomState(2)
    hypers = {k: v + 0.3 * rs.randn() for k, v in tk.HYPER_INIT.items()}
    emb = rs.randn(len(muts), 6).astype(np.float32) if with_emb else None
    a, b = tuple(t[:40] for t in enc), tuple(t[20:] for t in enc)
    with jax.enable_x64(False):
        want = np.asarray(jax.jit(lambda h, x, y, ea, eb: jk.full_kernel(h, data, x, y, ea, eb))(
            _jhypers(hypers), tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)),
            None if emb is None else jnp.asarray(emb[:40]),
            None if emb is None else jnp.asarray(emb[20:])))
    tables = tk.DeviceTables(data, "cpu")
    th = {k: torch.tensor(v, dtype=torch.float32) for k, v in hypers.items()}
    ta, tb = tk._as_tensors(a, "cpu"), tk._as_tensors(b, "cpu")
    te = (None, None) if emb is None else (torch.from_numpy(emb[:40]), torch.from_numpy(emb[20:]))
    got = tk.full_kernel(th, tables, ta, tb, *te).numpy()
    assert got.shape == (40, 40)
    np.testing.assert_allclose(got, want, rtol=GRAM_RTOL, atol=1e-6)
    tables.distance = torch.zeros_like(tables.distance)  # the distance term dropped
    bad = tk.full_kernel(th, tables, ta, tb, *te).numpy()
    assert not np.allclose(bad, want, rtol=GRAM_RTOL * 100, atol=1e-4)


def test_nll_fit_and_predict_match_jax():
    _, muts, data, y = world(n=50, seed=3)
    enc = tk.encode_variants(muts)
    train, test = tuple(t[:40] for t in enc), tuple(t[40:] for t in enc)
    zs = np.random.RandomState(4).randn(50)
    hypers = dict(tk.HYPER_INIT)
    with jax.enable_x64(False):
        want_nll = float(jk.neg_log_marginal_likelihood(
            _jhypers(hypers), data, tuple(map(jnp.asarray, train)),
            jnp.asarray(y[:40], jnp.float32), jnp.asarray(zs[:40], jnp.float32)))
        jh = jk.fit(data, train, y[:40], zero_shot=zs[:40], steps=20)
        want_pred = jk.predict(jh, data, train, y[:40], test, zero_shot_train=zs[:40],
                               zero_shot_test=zs[40:])
    tables = tk.DeviceTables(data, "cpu")
    th = {k: torch.tensor(v, dtype=torch.float32) for k, v in hypers.items()}
    got_nll = float(tk.neg_log_marginal_likelihood(
        th, tables, tk._as_tensors(train, "cpu"), torch.tensor(y[:40], dtype=torch.float32),
        torch.tensor(zs[:40], dtype=torch.float32)))
    assert abs(got_nll - want_nll) < NLL_ATOL
    got_h = tk.fit(data, train, y[:40], zero_shot=zs[:40], steps=20, device="cpu")
    for k in tk.HYPER_INIT:
        assert abs(float(got_h[k]) - float(jh[k])) < FIT_ATOL, k
    got_pred = tk.predict(got_h, data, train, y[:40], test, zero_shot_train=zs[:40],
                          zero_shot_test=zs[40:], device="cpu")
    np.testing.assert_allclose(got_pred, want_pred, atol=PRED_ATOL, rtol=0)
    again = tk.fit(data, train, y[:40], zero_shot=zs[:40], steps=20, device="cpu")
    assert all(torch.equal(again[k], got_h[k]) for k in got_h)  # deterministic
    # the distance term dropped: the fit goes elsewhere
    with mock.patch.object(tk.DeviceTables, "__init__", _no_distance):
        bad = tk.fit(data, train, y[:40], zero_shot=zs[:40], steps=20, device="cpu")
    assert max(abs(float(bad[k]) - float(jh[k])) for k in jh) > 10 * FIT_ATOL


ORIGINAL_INIT = tk.DeviceTables.__init__


def _no_distance(self, data, device):
    ORIGINAL_INIT(self, data, device)
    self.distance = torch.zeros_like(self.distance)


def test_mpnn_conditionals_match_jax():
    seq = "".join(np.random.RandomState(5).choice(list(AA), 24))
    coords = synthetic_helix_backbone(len(seq), seed=5)
    coords[:, 1] += 0.05 * np.random.RandomState(5).randn(len(seq), 3)
    jc = jm.MpnnConfig(name="kermut_probs", hidden_dim=32, edge_features=32, k_neighbors=8)
    tc = tm.MpnnConfig(name="kermut_probs", hidden_dim=32, edge_features=32, k_neighbors=8)
    with jax.enable_x64(False):
        params = jm.init_params(jax.random.PRNGKey(0), jc)
        with mock.patch.object(jm, "decode", jax.jit(jm.decode, static_argnums=1)):
            want = jk.conditional_probs_from_mpnn(params, jc, coords, seq, n_orders=3, seed=2)
    model = tm.load_state_dict(tm.params_from_jax(jax.tree_util.tree_map(np.asarray, params), tc),
                               tc, device="cpu")
    got = tk.conditional_probs_from_mpnn(model, coords, seq, n_orders=3, seed=2)
    assert got.shape == (len(seq), 20)
    np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-12)
    np.testing.assert_allclose(got, want, atol=PROBS_ATOL, rtol=0)
    other = tk.conditional_probs_from_mpnn(model, coords, seq, n_orders=3, seed=3)
    assert np.abs(other - want).max() > 10 * PROBS_ATOL  # other orders, other conditionals
