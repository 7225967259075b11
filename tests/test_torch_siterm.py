"""The port's SiteRM (proteingym_tpu_torch.models.siterm) against the JAX
package's. The JAX side runs the fits and the expm as in production,
float32, inside ``jax.enable_x64(False)`` (the test harness turns x64 on
for every JAX test); the port runs in float32 on the CPU.

- host copies, equal exactly: the greedy and the NJ cherries, the
  weighted subsample, the rate-matrix file reader and its reordering, the
  stationary distribution, the uniform prior and the prior's transition
  table;
- F81: the site frequencies within 1e-12, the rates within rtol 1e-5;
- GTR: the loss and its gradient at a point in float64 on both sides;
  the Loewner backward against float64 finite differences, and finite at
  the uniform prior, where ``torch.linalg.eigh``'s own gradient is NaN;
  the fit after 30 epochs (the same grid categories, rate matrices
  within a relative Frobenius bound and within twice the distance of
  JAX's own float64 fit from its float32 fit), its scores within a bound and by
  Spearman, and ``score_from_rate_matrices`` against
  ``jax.scipy.linalg.expm``;
- the ``siterm`` scorer (GTR and ``method=f81``) through both CLIs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from scipy.stats import spearmanr  # noqa: E402

from proteingym_tpu.models import siterm as jsiterm  # noqa: E402
from proteingym_tpu_torch.models import siterm as tsiterm  # noqa: E402

from test_torch_gemme import AA, alignment, run_clis, score_column, write_baseline_world  # noqa: E402

F32 = lambda: jax.enable_x64(False)  # noqa: E731
PI_ATOL = 1e-12  # float64 on both sides, sums in another order
MU_RTOL = 1e-5  # 200 float32 Adam steps on each side
# float64 loss and gradient on both sides: the order of the sums differs
LOSS_RTOL, GRAD_ATOL = 1e-10, 1e-8
# float32 fits: Adam carries float32 rounding of the eigenvectors forward,
# so JAX's own float64 fit drifts from its float32 fit about as far as the
# port's does; the test holds the port within GTR30_OWN_DRIFT times that
# drift, and within a relative Frobenius bound
GTR30_REL_FRO, GTR30_OWN_DRIFT, GTR30_SCORE_ATOL, GTR30_SPEARMAN = 5e-2, 2.0, 0.3, 0.99
GTR100_SCORE_ATOL, GTR100_SPEARMAN = 5e-2, 0.999
EXPM_ATOL = 1e-5  # float32 expm: Pade (JAX) against Taylor (torch)


def _rate_file(tmp_path, Q, states):
    path = tmp_path / "rates.txt"
    with open(path, "w") as f:
        f.write("\t".join(states) + "\n\n")
        for s, row in zip(states, Q):
            f.write(s + "\t" + "\t".join(repr(float(v)) for v in row) + "\n")
    return path


def _random_reversible(rs, q=21):
    pi = rs.dirichlet(np.ones(q) * 2)
    s = rs.gamma(2.0, 1.0, (q, q))
    s = s + s.T
    Q = s * pi[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(1))
    return Q / -(pi * np.diag(Q)).sum()


@pytest.mark.parametrize("n", [2, 3, 64, 300])
def test_cherries_equal_jax(n):
    rs = np.random.RandomState(n)
    matrix = alignment(rs, n, 30)
    assert tsiterm.cherry_pairs(matrix) == jsiterm.cherry_pairs(matrix)
    assert tsiterm.cherry_pairs(matrix, 3) == jsiterm.cherry_pairs(matrix, 3)
    got = tsiterm.cherry_pairs_nj(matrix)
    assert got == jsiterm.cherry_pairs_nj(matrix) and len(got) >= 1
    assert tsiterm.cherry_pairs_nj(matrix, 1) == jsiterm.cherry_pairs_nj(matrix, 1)
    assert tsiterm.cherry_pairs_nj(matrix[:1]) == jsiterm.cherry_pairs_nj(matrix[:1]) == []


@pytest.mark.parametrize("weighted", [True, False])
def test_weighted_subsample_equals_jax(weighted):
    rs = np.random.RandomState(1)
    matrix = alignment(rs, 500, 20)
    weights = rs.rand(500) * (rs.rand(500) < 0.3) if weighted else None
    for k in (100, 499, 500, 800):
        np.testing.assert_array_equal(tsiterm._weighted_subsample(matrix, weights, k, 3),
                                      jsiterm._weighted_subsample(matrix, weights, k, 3))


def test_rate_matrix_files_and_prior_equal_jax(tmp_path):
    rs = np.random.RandomState(2)
    Q = _random_reversible(rs)
    paml = list("ARNDCQEGHILKMFPSTWYV-")
    perm = [tsiterm.ALPHABET21.index(a) for a in paml]
    path = _rate_file(tmp_path, Q[np.ix_(perm, perm)], paml)
    got, states = tsiterm.read_rate_matrix(path)
    want, want_states = jsiterm.read_rate_matrix(path)
    assert states == want_states == paml
    np.testing.assert_array_equal(got, want)
    reordered = tsiterm.reorder_rate_matrix(got, states)
    np.testing.assert_array_equal(reordered, jsiterm.reorder_rate_matrix(want, want_states))
    np.testing.assert_array_equal(reordered, Q)
    with pytest.raises(ValueError, match="don't cover"):
        tsiterm.reorder_rate_matrix(got, paml[:-1] + ["X"])
    np.testing.assert_array_equal(tsiterm.stationary_distribution(Q),
                                  jsiterm.stationary_distribution(Q))
    np.testing.assert_array_equal(tsiterm.uniform_prior(), jsiterm.uniform_prior())
    taus, rates = np.geomspace(1e-3, 10, 9), np.geomspace(1 / 8, 8, 4)
    for prior in (Q, tsiterm.uniform_prior()):
        np.testing.assert_array_equal(tsiterm._prior_transition_table(prior, rates, taus),
                                      jsiterm._prior_transition_table(prior, rates, taus))


@pytest.mark.parametrize("weighted", [True, False])
def test_f81_equals_jax(weighted):
    rs = np.random.RandomState(3)
    matrix = alignment(rs, 400, 40)
    weights = rs.rand(400) if weighted else None
    pi = tsiterm.estimate_site_frequencies(matrix, weights, device="cpu")
    np.testing.assert_allclose(pi, jsiterm.estimate_site_frequencies(matrix, weights),
                               atol=PI_ATOL, rtol=0)
    got = tsiterm.fit_siterm(matrix, weights, max_sequences=256, device="cpu")
    with F32():
        want = jsiterm.fit_siterm(matrix, weights, max_sequences=256)
    np.testing.assert_allclose(got.pi, want.pi, atol=PI_ATOL, rtol=0)
    assert got.mu.dtype == np.float32
    np.testing.assert_allclose(got.mu, want.mu, rtol=MU_RTOL, atol=0)
    focus = "".join(AA[c - 1] for c in matrix[0])
    mutants = [f"{focus[p]}{p + 1}{a}" for p in range(40) for a in "DGR" if a != focus[p]]
    np.testing.assert_allclose(tsiterm.score_mutants(got, focus, mutants + ["WT"]),
                               jsiterm.score_mutants(want, focus, mutants + ["WT"]),
                               atol=1e-4, rtol=0)


def _jax_gtr_loss(s_raw, pi_raw, counts, taus):
    """The JAX fit's total_loss (siterm.py:498-523), rebuilt on its own
    functions for a point of our choosing."""
    q = 21
    iu = np.triu_indices(q, 1)

    def site_loss(s, p, cnt):
        pi = jax.nn.softmax(p)
        S = jnp.zeros((q, q), s.dtype).at[iu].set(jnp.exp(s))
        S = S + S.T
        Q = S * pi[None, :]
        Q = Q - jnp.diag(Q.sum(1))
        dp = jnp.sqrt(pi + 1e-12)
        B = dp[:, None] * Q / dp[None, :]
        B = 0.5 * (B + B.T)
        M = jsiterm._expm_sym_multi(B, taus)
        P = (1.0 / dp)[None, :, None] * M * dp[None, None, :]
        return -jnp.sum(cnt * jnp.log(jnp.clip(P, 1e-16, None)))

    return jax.vmap(site_loss)(s_raw, pi_raw, counts).sum()


def _point(rs, L=5, G=4, q=21, spread=0.3):
    prior = tsiterm.uniform_prior(q)
    pi = tsiterm.stationary_distribution(prior)
    iu = np.triu_indices(q, 1)
    s0 = np.log(prior[iu] / pi[iu[1]])
    s = np.tile(s0, (L, 1)) + spread * rs.randn(L, len(s0))
    p = np.tile(np.log(pi), (L, 1)) + spread * rs.randn(L, q)
    counts = rs.gamma(0.5, 2.0, (L, G, q, q))
    taus = np.geomspace(1e-2, 3, G)
    return s, p, counts, taus, tuple(torch.as_tensor(a) for a in iu)


def test_gtr_loss_and_gradient_equal_jax_in_float64():
    s, p, counts, taus, iu = _point(np.random.RandomState(4))
    want, (gs, gp) = jax.value_and_grad(_jax_gtr_loss, argnums=(0, 1))(
        jnp.asarray(s), jnp.asarray(p), jnp.asarray(counts), jnp.asarray(taus))
    st = torch.tensor(s, requires_grad=True)
    pt = torch.tensor(p, requires_grad=True)
    got = tsiterm.gtr_loss(st, pt, torch.tensor(counts), torch.tensor(taus), iu)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(gs), atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(gp), atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("degenerate", [False, True])
def test_loewner_backward_equals_finite_differences(degenerate):
    rs = np.random.RandomState(5)
    q = 6
    if degenerate:  # the uniform prior's shape: one eigenvalue 5-fold
        A = np.full((q, q), 1.0 / (q - 1))
        np.fill_diagonal(A, -1.0)
    else:
        A = rs.randn(q, q)
    A = torch.tensor(np.stack([A, rs.randn(q, q)]), requires_grad=True)
    taus = torch.tensor([0.01, 0.5, 2.0], dtype=torch.float64)
    fn = lambda a: tsiterm._ExpmSymMulti.apply(0.5 * (a + a.transpose(-1, -2)), taus)
    assert torch.autograd.gradcheck(fn, (A,), eps=1e-6, atol=1e-7, rtol=1e-5)


def test_backward_is_finite_at_the_uniform_prior_where_eigh_is_not(monkeypatch):
    L, q = 3, 21
    prior = tsiterm.uniform_prior(q)
    pi = tsiterm.stationary_distribution(prior)
    iu = np.triu_indices(q, 1)
    s = torch.tensor(np.tile(np.log(prior[iu] / pi[iu[1]]), (L, 1)), dtype=torch.float32,
                     requires_grad=True)
    p = torch.tensor(np.tile(np.log(pi), (L, 1)), dtype=torch.float32, requires_grad=True)
    counts = torch.rand(L, 4, q, q, generator=torch.Generator().manual_seed(0))
    taus = torch.tensor([0.01, 0.1, 1.0, 5.0])
    iut = tuple(torch.as_tensor(a) for a in iu)
    tsiterm.gtr_loss(s, p, counts, taus, iut).backward()
    assert torch.isfinite(s.grad).all() and torch.isfinite(p.grad).all()
    assert s.grad.abs().max() > 0

    class EighExpm:  # the same function through torch's own eigh gradient
        @staticmethod
        def apply(B, t):
            lam, U = torch.linalg.eigh(B)
            return (U[:, None] * torch.exp(lam[:, None, :] * t[None, :, None])[:, :, None, :]
                    ) @ U.transpose(-1, -2)[:, None]

    s2, p2 = s.detach().clone().requires_grad_(True), p.detach().clone().requires_grad_(True)
    monkeypatch.setattr(tsiterm, "_ExpmSymMulti", EighExpm)
    tsiterm.gtr_loss(s2, p2, counts, taus, iut).backward()
    assert not torch.isfinite(s2.grad).all()


@pytest.fixture(scope="module")
def gtr_pair():
    rs = np.random.RandomState(0)
    matrix = alignment(rs, 300, 40)
    weights = rs.rand(300)
    got = tsiterm.fit_site_rate_matrices(matrix, weights, epochs=30, max_sequences=128,
                                         device="cpu")
    with F32():
        want = jsiterm.fit_site_rate_matrices(matrix, weights, epochs=30, max_sequences=128)
    want64 = jsiterm.fit_site_rate_matrices(matrix, weights, epochs=30, max_sequences=128)
    return matrix, got, want, want64


def test_gtr_fit_after_30_epochs_equals_jax(gtr_pair):
    matrix, got, want, want64 = gtr_pair
    assert got.rate_matrices.dtype == want.rate_matrices.dtype == np.float32
    assert got.rate_matrices.shape == (40, 21, 21)
    np.testing.assert_array_equal(got.site_rates, want.site_rates)  # the grid categories
    rel = np.linalg.norm(got.rate_matrices - want.rate_matrices) / np.linalg.norm(
        want.rate_matrices)
    own = np.linalg.norm(want64.rate_matrices - want.rate_matrices) / np.linalg.norm(
        want.rate_matrices)
    assert rel <= GTR30_REL_FRO and rel <= GTR30_OWN_DRIFT * own
    np.testing.assert_allclose(got.rate_matrices.sum(-1), 0.0, atol=1e-5)  # rows of a Q
    focus = "".join(AA[c - 1] for c in matrix[0])
    mutants = [f"{focus[p]}{p + 1}{a}" for p in range(40) for a in AA if a != focus[p]]
    scores = tsiterm.score_mutants_gtr(got, focus, mutants, device="cpu")
    with F32():
        ref = jsiterm.score_mutants_gtr(want, focus, mutants)
    np.testing.assert_allclose(scores, ref, atol=GTR30_SCORE_ATOL, rtol=0)
    assert spearmanr(scores, ref)[0] >= GTR30_SPEARMAN


def test_score_from_rate_matrices_equals_jax_expm(gtr_pair):
    matrix, got, _, _ = gtr_pair
    focus = "".join(AA[c - 1] for c in matrix[0])
    mutants = [f"{focus[p]}{p + 1}{a}" for p in range(40) for a in "-CW" if a != focus[p]]
    mutants += [f"{mutants[0]}:{mutants[-1]}", "WT"]
    for t in (1.0, 0.3):
        with F32():
            want = jsiterm.score_from_rate_matrices(got.rate_matrices, t, focus, mutants,
                                                    alphabet=tsiterm.ALPHABET21)
        np.testing.assert_allclose(
            tsiterm.score_from_rate_matrices(got.rate_matrices, t, focus, mutants,
                                             alphabet=tsiterm.ALPHABET21, device="cpu"),
            want, atol=EXPM_ATOL, rtol=0)


@pytest.mark.parametrize("extra", [[], ["method=f81"]], ids=["gtr", "f81"])
def test_siterm_scorer_writes_the_jax_cli_file(tmp_path, extra):
    write_baseline_world(tmp_path, n_rows=400, seed=5)
    port, want = run_clis(tmp_path, "siterm", extra=extra, jax_context=F32)
    assert port[0] == want[0] and port[0][-1] == "SiteRM_score"
    assert [r[:-1] for r in port] == [r[:-1] for r in want]
    got, ref = score_column(port), score_column(want)
    assert np.isnan(got[-3:-1]).all() and np.isnan(ref[-3:-1]).all()
    assert got[-1] == ref[-1] == 0.0
    live = np.isfinite(ref)
    np.testing.assert_allclose(got[live], ref[live], atol=GTR100_SCORE_ATOL if not extra
                               else 1e-4, rtol=0)
    assert spearmanr(got[live], ref[live])[0] >= GTR100_SPEARMAN
