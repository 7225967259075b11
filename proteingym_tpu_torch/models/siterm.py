"""SiteRM: per-site rate-matrix phylogenetic model, CherryML-style
(counterpart of proteingym_tpu/models/siterm.py).

The reference (ref proteingym/baselines/SiteRM/compute_fitness.py:60-200)
learns one reversible rate matrix per site with CherryML over a FastTree
phylogeny and scores

  log P(y | x, t) = log P(x | x, t)
      + sum_{i: x_i != y_i} [ log P(y_i | x_i, t) - log P(x_i | x_i, t) ]

from the matrix exponentials of the per-site rate matrices. As in the JAX
package, the cherries come from a neighbour-joining tree over a weighted
row subsample (``native.nj_tree``, pruned FastCherries-style), and there
are two models:

- F81 (``fit_siterm``, ``--extra method=f81``): site frequencies pi_i and
  one rate mu_i per site, fit by 200 Adam steps on the cherry likelihood;
  P_i(t) is closed-form.
- GTR (``fit_site_rate_matrices``, the scorer's default): per-site
  21-state reversible matrices Q = S diag(pi), trained by 100 Adam epochs
  on cherry counts quantised to a time grid and blended with the prior's
  pseudocounts; expm through the eigendecomposition of the symmetrised
  matrix, batched over sites.

On ``device``: the site frequencies (one weighted ``bincount``), both
Adam fits (float32, ``torch.optim.Adam``, optax's update), the grid
alternation of cherry times and site rates, the cherry counts
(``index_put_`` of halves, exact in float32) and the scores' ``matrix_exp``.
On the host, copied: the subsample, the cherries, the prior's
eigendecomposition and transition table, and the rate-matrix files. The
GTR gradient goes through ``_ExpmSymMulti``, whose backward is the
Loewner divided-difference form: ``torch.linalg.eigh``'s own gradient is
NaN at repeated eigenvalues, and the prior at initialisation gives every
site a 20-fold one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from proteingym_tpu_torch import native
from proteingym_tpu_torch.data.mutants import is_wt_row
from proteingym_tpu_torch.devices import no_tf32, resolve_device
from proteingym_tpu_torch.msa.columns import column_counts

AA20 = "ACDEFGHIKLMNPQRSTVWY"
GAP = "-"
ALPHABET21 = AA20 + GAP


# ---------------------------------------------------------------------------
# Cherries (host)
# ---------------------------------------------------------------------------

def cherry_pairs(matrix: np.ndarray, max_pairs: Optional[int] = None
                 ) -> List[Tuple[int, int]]:
    """Greedy min-Hamming pairing of rows, each row used at most once
    (the JAX package's pairing without its native library). O(N^2 L)."""
    n = matrix.shape[0]
    nongap = matrix > 0
    sim = np.zeros((n, n))
    for i in range(n):
        both = nongap[i] & nongap
        match = (matrix == matrix[i]) & both
        denom = np.maximum(both.sum(1), 1)
        sim[i] = match.sum(1) / denom
    np.fill_diagonal(sim, -1)
    used = np.zeros(n, bool)
    pairs = []
    order = np.dstack(np.unravel_index(np.argsort(-sim, axis=None), sim.shape))[0]
    for i, j in order:
        if used[i] or used[j] or i == j:
            continue
        used[i] = used[j] = True
        pairs.append((int(i), int(j)))
        if max_pairs and len(pairs) >= max_pairs:
            break
    return pairs


def cherry_pairs_nj(matrix: np.ndarray, max_pairs: Optional[int] = None
                    ) -> List[Tuple[int, int]]:
    """Cherries of a neighbour-joining tree with iterative pruning (the
    FastCherries recipe: take every sibling-leaf pair, prune them, repeat).
    Walking the merges in creation order prunes bottom-up: each subtree
    carries at most one unpaired leaf, and two such leaves meeting at a
    merge form a cherry. Fewer than 2 rows have none."""
    n = matrix.shape[0]
    if n < 2:
        return []
    left, right, _, _ = native.nj_tree(matrix)
    rep = np.full(2 * n - 1, -1, np.int64)
    rep[:n] = np.arange(n)
    pairs: List[Tuple[int, int]] = []
    for k in range(n - 1):
        a, b = int(left[k]), int(right[k])
        ra, rb = rep[a], rep[b]
        if ra >= 0 and rb >= 0:
            pairs.append((int(ra), int(rb)))
            if max_pairs and len(pairs) >= max_pairs:
                return pairs
        else:
            rep[n + k] = ra if ra >= 0 else rb
    return pairs


def _weighted_subsample(matrix: np.ndarray, weights: Optional[np.ndarray],
                        max_sequences: int, seed: int) -> np.ndarray:
    """Weighted without-replacement row subsample (``RandomState(seed)``).
    A tiny floor keeps zero-weight rows selectable, so ``replace=False``
    stays feasible when fewer than ``max_sequences`` rows weigh > 0."""
    if matrix.shape[0] <= max_sequences:
        return matrix
    rs = np.random.RandomState(seed)
    p = None
    if weights is not None:
        w = np.asarray(weights, np.float64)
        w = w + (w.sum() + 1.0) * 1e-12
        p = w / w.sum()
    idx = rs.choice(matrix.shape[0], max_sequences, replace=False, p=p)
    return matrix[idx]


def _cherry_arrays(pair_matrix: np.ndarray, pairs) -> Tuple[np.ndarray, np.ndarray]:
    xs = np.stack([pair_matrix[i] for i, _ in pairs])  # (P, L), 0 = gap
    ys = np.stack([pair_matrix[j] for _, j in pairs])
    return xs, ys


# ---------------------------------------------------------------------------
# F81-style per-site model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SiteRmModel:
    pi: np.ndarray  # (L, q) site stationary distributions
    mu: np.ndarray  # (L,) site rates
    t: float = 1.0
    alphabet: str = AA20

    def transition_prob(self) -> np.ndarray:
        """(L, q, q) P_i(t), the closed-form F81 exponential."""
        e = np.exp(-self.mu * self.t)[:, None, None]
        eye = np.eye(self.pi.shape[1])[None]
        return e * eye + (1.0 - e) * self.pi[:, None, :]


def estimate_site_frequencies(matrix: np.ndarray, weights: Optional[np.ndarray] = None,
                              q: int = 20, pseudocount: float = 0.5,
                              device="cuda") -> np.ndarray:
    counts = column_counts(matrix, weights, q=q, device=device) + pseudocount
    return counts / counts.sum(1, keepdims=True)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def fit_site_rates(matrix: np.ndarray, pi: np.ndarray, pairs: Sequence[Tuple[int, int]],
                   t: float = 1.0, steps: int = 200, learning_rate: float = 0.1,
                   device="cuda") -> np.ndarray:
    """Per-site mu maximising the cherry-transition likelihood, by
    ``steps`` full-batch Adam steps over all L sites at once in float32
    (under F81, P(y | x, t) = e^{-mu t} [x == y] + (1 - e^{-mu t}) pi[y],
    and the likelihood factorises over sites)."""
    dev = resolve_device(device)
    xs, ys = _cherry_arrays(matrix, pairs)
    valid = (xs > 0) & (ys > 0)
    same = (xs == ys) & valid
    pi_y = np.zeros(xs.shape)
    ok = ys > 0
    pi_y[ok] = pi[np.nonzero(ok)[1], ys[ok] - 1]
    same_t = torch.as_tensor(same, device=dev)
    valid_t = torch.as_tensor(valid, device=dev)
    pi_y_t = torch.as_tensor(pi_y, dtype=torch.float32, device=dev)

    raw = torch.zeros(matrix.shape[1], dtype=torch.float32, device=dev, requires_grad=True)
    opt = torch.optim.Adam([raw], lr=learning_rate)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        e = torch.exp(-_softplus(raw) * t)[None, :]
        p = torch.where(same_t, e + (1 - e) * pi_y_t, (1 - e) * pi_y_t)
        ll = torch.where(valid_t, torch.log(torch.clamp(p, min=1e-12)), 0.0)
        (-ll.sum()).backward()
        opt.step()
    with torch.no_grad():
        return _softplus(raw).cpu().numpy()


def fit_siterm(matrix: np.ndarray, weights: Optional[np.ndarray] = None, t: float = 1.0,
               max_pairs: Optional[int] = None, max_sequences: int = 2048, seed: int = 0,
               device="cuda") -> SiteRmModel:
    """The F81 model: site frequencies from the whole alignment, cherries
    from a weighted subsample of ``max_sequences`` rows."""
    pi = estimate_site_frequencies(matrix, weights, device=device)
    pair_matrix = _weighted_subsample(matrix, weights, max_sequences, seed)
    pairs = cherry_pairs_nj(pair_matrix, max_pairs=max_pairs)
    mu = fit_site_rates(pair_matrix, pi, pairs, t=t, device=device)
    return SiteRmModel(pi=pi, mu=mu, t=t)


def _score_log_tables(logp: np.ndarray, alphabet: str, wt_focus_seq: Optional[str],
                      mutants: Sequence[str], offset_idx: int) -> np.ndarray:
    """Sum over a mutant's substitutions of logp[i, wt, mt] - logp[i, wt, wt];
    a WT row scores 0. With ``wt_focus_seq`` a wrong WT letter raises."""
    aa_idx = {a: i for i, a in enumerate(alphabet)}
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        for tok in m.split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if wt_focus_seq is not None and wt_focus_seq[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            a, b = aa_idx[wt], aa_idx[mt]
            out[i] += logp[pos, a, b] - logp[pos, a, a]
    return out


def score_mutants(model: SiteRmModel, wt_focus_seq: str, mutants: Sequence[str],
                  offset_idx: int = 1) -> np.ndarray:
    """Relative transition log-likelihood (the log P(x | x, t) offset is
    the same for every mutant of an assay)."""
    logp = np.log(np.maximum(model.transition_prob(), 1e-30))
    return _score_log_tables(logp, model.alphabet, wt_focus_seq, mutants, offset_idx)


# ---------------------------------------------------------------------------
# Per-site 21-state reversible rate matrices (GTR)
# ---------------------------------------------------------------------------

def read_rate_matrix(path) -> Tuple[np.ndarray, List[str]]:
    """A cherryml-format rate matrix file (first line the states, then
    'state<TAB>values...' rows), e.g. the reference's lg_with_gaps.txt."""
    with open(path) as f:
        lines = [line.rstrip("\n") for line in f if line.strip()]
    states = lines[0].split()
    rows = [[float(v) for v in line.split()[1:]] for line in lines[1:]]
    return np.asarray(rows, np.float64), states


def reorder_rate_matrix(Q: np.ndarray, states: Sequence[str],
                        alphabet: str = ALPHABET21) -> np.ndarray:
    """Permute a rate matrix from its file's state order into ``alphabet``
    order (lg_with_gaps.txt is in PAML order, A R N D C Q E G H I L K M F P
    S T W Y V -, not alphabetical)."""
    states = list(states)
    if sorted(states) != sorted(alphabet):
        raise ValueError(f"rate-matrix states {states} don't cover alphabet {alphabet!r}")
    perm = np.asarray([states.index(a) for a in alphabet])
    return Q[np.ix_(perm, perm)]


def stationary_distribution(Q: np.ndarray) -> np.ndarray:
    """pi with pi @ Q = 0, from the null left eigenvector."""
    w, v = np.linalg.eig(Q.T)
    pi = np.abs(np.real(v[:, np.argmin(np.abs(w))]))
    return pi / pi.sum()


def uniform_prior(q: int = 21) -> np.ndarray:
    """The prior without an LG file: all exchanges equal, expected rate 1."""
    Q = np.full((q, q), 1.0 / (q - 1))
    np.fill_diagonal(Q, -1.0)
    return Q


def _reversible_expm_factors(Q: np.ndarray):
    """(pi, U, lam, D^1/2) with expm(tQ) = D^-1/2 U e^{lam t} U^T D^1/2."""
    pi = stationary_distribution(Q)
    dp = np.sqrt(pi)
    B = dp[:, None] * Q / dp[None, :]
    B = 0.5 * (B + B.T)  # symmetric up to float error for a reversible Q
    lam, U = np.linalg.eigh(B)
    return pi, U, lam, dp


def _prior_transition_table(Q: np.ndarray, rates: np.ndarray, taus: np.ndarray) -> np.ndarray:
    """(R, T, q, q) transition probabilities expm(r tau Q), float64."""
    _, U, lam, dp = _reversible_expm_factors(Q)
    rt = rates[:, None] * taus[None, :]
    e = np.exp(lam[None, None, :] * rt[..., None])
    M = np.einsum("ak,rtk,bk->rtab", U, e, U)
    P = (1.0 / dp)[None, None, :, None] * M * dp[None, None, None, :]
    return np.clip(P, 1e-16, None)


class _ExpmSymMulti(torch.autograd.Function):
    """expm(B tau) of a batch of symmetric (q, q) matrices B over a vector
    of taus: (S, q, q), (G,) -> (S, G, q, q). The backward is the VJP of
    the JAX package's Loewner JVP (siterm.py:_expm_sym_multi):
    B_bar = sym(U (sum_g F_g o (U^T G_bar_g U)) U^T), with F_g[i, j] =
    (e^{lam_i tau_g} - e^{lam_j tau_g}) / (lam_i - lam_j), and tau_g
    e^{lam_i tau_g} where |lam_i - lam_j| <= 1e-9, so it stays finite at
    repeated eigenvalues."""

    @staticmethod
    def forward(ctx, B, taus):
        lam, U = torch.linalg.eigh(B)
        e = torch.exp(lam[:, None, :] * taus[None, :, None])  # (S, G, q)
        out = (U[:, None] * e[:, :, None, :]) @ U.transpose(-1, -2)[:, None]
        ctx.save_for_backward(U, lam, e, taus)
        return out

    @staticmethod
    def backward(ctx, grad):
        U, lam, e, taus = ctx.saved_tensors
        dlam = (lam[:, :, None] - lam[:, None, :])[:, None]  # (S, 1, q, q)
        de = e[..., :, None] - e[..., None, :]  # (S, G, q, q)
        safe = dlam.abs() > 1e-9
        F = torch.where(safe, de / torch.where(safe, dlam, torch.ones_like(dlam)),
                        taus[None, :, None, None] * e[..., :, None])
        Ut = U.transpose(-1, -2)
        inner = Ut[:, None] @ grad @ U[:, None]  # U^T G_bar_g U
        X = U @ (F * inner).sum(1) @ Ut
        return 0.5 * (X + X.transpose(-1, -2)), None


@dataclasses.dataclass
class SiteRmGtrModel:
    rate_matrices: np.ndarray  # (L, q, q)
    # the grid categories the alternation assigned (diagnostic: the learned
    # Q absorbs the rate scale, so scoring uses expm(Q t) alone)
    site_rates: np.ndarray  # (L,)
    t: float = 1.0
    alphabet: str = ALPHABET21


def _make_Q(s_raw: torch.Tensor, pi_raw: torch.Tensor, iu) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, q, q) reversible Q = S diag(pi) - diag(row sums) from (S, q(q-1)/2)
    log exchangeabilities and (S, q) stationary logits."""
    q = pi_raw.shape[-1]
    pi = torch.softmax(pi_raw, dim=-1)
    s = torch.zeros(s_raw.shape[0], q * q, dtype=s_raw.dtype, device=s_raw.device)
    s[:, iu[0] * q + iu[1]] = torch.exp(s_raw)
    s = s.view(-1, q, q)
    s = s + s.transpose(-1, -2)
    Q = s * pi[:, None, :]
    return Q - torch.diag_embed(Q.sum(-1)), pi


def gtr_loss(s_raw, pi_raw, counts, taus, iu) -> torch.Tensor:
    """-sum over sites, buckets and (a, b) of counts * log expm(tau Q)[a, b]."""
    Q, pi = _make_Q(s_raw, pi_raw, iu)
    dp = torch.sqrt(pi + 1e-12)
    B = dp[:, :, None] * Q / dp[:, None, :]
    B = 0.5 * (B + B.transpose(-1, -2))
    M = _ExpmSymMulti.apply(B, taus)  # (S, G, q, q)
    P = (1.0 / dp)[:, None, :, None] * M * dp[:, None, None, :]
    return -torch.sum(counts * torch.log(torch.clamp(P, min=1e-16)))


def fit_gtr_params(counts: torch.Tensor, taus: torch.Tensor, s0: torch.Tensor,
                   pi0: torch.Tensor, epochs: int, learning_rate: float) -> torch.Tensor:
    """``epochs`` full-batch Adam steps from (s0, pi0) on the (S, G, q, q)
    counts; returns the learned (S, q, q) rate matrices."""
    q = pi0.shape[-1]
    iu = tuple(torch.as_tensor(a, device=counts.device) for a in np.triu_indices(q, 1))
    s_raw = s0.clone().requires_grad_(True)
    pi_raw = pi0.clone().requires_grad_(True)
    opt = torch.optim.Adam([s_raw, pi_raw], lr=learning_rate)
    with no_tf32():
        for _ in range(epochs):
            opt.zero_grad(set_to_none=True)
            gtr_loss(s_raw, pi_raw, counts, taus, iu).backward()
            opt.step()
        with torch.no_grad():
            return _make_Q(s_raw, pi_raw, iu)[0]


def _grid_alternation(logP: torch.Tensor, X: torch.Tensor, Y: torch.Tensor, mid_rate: int):
    """Two rounds of (cherry times | site rates) then (site rates | cherry
    times), each the grid argmax of the summed log transition
    probabilities, in float32 and chunked to 2^24 gathered values as in the
    JAX package. Returns (time_idx (P,), site_rate_idx (L,))."""
    R_n, T_n = logP.shape[:2]
    P_n, L = X.shape
    dev = X.device
    site_rate_idx = torch.full((L,), int(mid_rate), dtype=torch.long, device=dev)
    site_chunk = max(1, (1 << 24) // max(P_n * T_n, 1))
    pair_chunk = max(1, (1 << 24) // max(R_n * L, 1))
    for _ in range(2):
        cherry_ll = torch.zeros(P_n, T_n, dtype=torch.float32, device=dev)
        for s0 in range(0, L, site_chunk):
            sl = slice(s0, min(s0 + site_chunk, L))
            lp = logP[site_rate_idx[sl]]  # (Ls, T, q, q)
            sites = torch.arange(lp.shape[0], device=dev)[None, :]
            cherry_ll += lp[sites, :, X[:, sl], Y[:, sl]].sum(1)  # (P, Ls, T) -> (P, T)
        time_idx = cherry_ll.argmax(1)
        rate_ll = torch.zeros(R_n, L, dtype=torch.float32, device=dev)
        for p0 in range(0, P_n, pair_chunk):
            pl = slice(p0, min(p0 + pair_chunk, P_n))
            lp_t = logP[:, time_idx[pl]]  # (R, Pc, q, q)
            pairs = torch.arange(lp_t.shape[1], device=dev)[:, None]
            rate_ll += lp_t[:, pairs, X[pl], Y[pl]].sum(1)  # (R, Pc, L) -> (R, L)
        site_rate_idx = rate_ll.argmax(0)
    return time_idx, site_rate_idx


def fit_site_rate_matrices(
    matrix: np.ndarray,
    weights: Optional[np.ndarray] = None,
    prior_Q: Optional[np.ndarray] = None,
    regularization_strength: float = 0.5,
    num_rate_categories: int = 20,
    quantization_grid_num_steps: int = 64,
    epochs: int = 100,
    learning_rate: float = 0.1,
    t: float = 1.0,
    max_sequences: int = 1024,
    max_pairs: Optional[int] = None,
    seed: int = 0,
    device="cuda",
) -> SiteRmGtrModel:
    """One reversible 21-state rate matrix per site from the cherry
    transitions of a weighted subsample of ``max_sequences`` rows."""
    dev = resolve_device(device)
    q = 21
    if prior_Q is None:
        prior_Q = uniform_prior(q)
    prior_pi = stationary_distribution(prior_Q)

    pair_matrix = _weighted_subsample(matrix, weights, max_sequences, seed)
    pairs = cherry_pairs_nj(pair_matrix, max_pairs=max_pairs)
    if not pairs:
        raise ValueError("need >= 2 sequences to extract cherries")
    xs, ys = _cherry_arrays(pair_matrix, pairs)
    # 21-state encoding: gap / indeterminate -> state 20
    X = torch.as_tensor(np.where(xs > 0, xs - 1, 20), device=dev).long()
    Y = torch.as_tensor(np.where(ys > 0, ys - 1, 20), device=dev).long()
    P_n, L = X.shape

    taus = np.geomspace(1e-3, 10.0, 2 * quantization_grid_num_steps + 1)
    rates = np.geomspace(1.0 / 8, 8.0, num_rate_categories)
    prior_P = _prior_transition_table(prior_Q, rates, taus)  # (R, T, q, q) float64
    logP = torch.as_tensor(np.log(prior_P).astype(np.float32), device=dev)
    mid_rate = np.argmin(np.abs(np.log(rates)))  # the category closest to 1
    time_idx, site_rate_idx = _grid_alternation(logP, X, Y, mid_rate)

    used, bucket = torch.unique(time_idx, return_inverse=True)  # sorted, as np.unique
    G = used.shape[0]
    # counts (L, G, q, q): symmetrised cherry transitions, halves (exact)
    counts = torch.zeros(L, G, q, q, dtype=torch.float32, device=dev)
    site = torch.arange(L, device=dev)[None, :].expand(P_n, L)
    g = bucket[:, None].expand(P_n, L)
    half = torch.full((P_n, L), 0.5, dtype=torch.float32, device=dev)
    counts.index_put_((site, g, X, Y), half, accumulate=True)
    counts.index_put_((site, g, Y, X), half, accumulate=True)
    # the prior's pseudocounts: a lambda share of each bucket's mass, shaped
    # as pi_a P_prior[r_i, tau_g, a, b]
    n_per_bucket = counts.sum((2, 3))
    prior_P_t = torch.as_tensor(prior_P, device=dev)
    prior_joint = (torch.as_tensor(prior_pi, device=dev)[None, None, :, None]
                   * prior_P_t[site_rate_idx[:, None], used[None, :]]).float()
    lam = regularization_strength
    counts = (1 - lam) * counts + lam * (n_per_bucket[..., None, None] * prior_joint)

    iu = np.triu_indices(q, 1)
    prior_s = np.log(np.maximum(prior_Q[iu] / prior_pi[iu[1]], 1e-8)).astype(np.float32)
    s0 = torch.as_tensor(prior_s, device=dev)[None].repeat(L, 1)
    pi0 = torch.as_tensor(np.log(prior_pi).astype(np.float32), device=dev)[None].repeat(L, 1)
    tau_used = torch.as_tensor(taus[used.cpu().numpy()], dtype=torch.float32, device=dev)
    Qs = fit_gtr_params(counts, tau_used, s0, pi0, epochs, learning_rate)
    return SiteRmGtrModel(rate_matrices=Qs.cpu().numpy(),
                          site_rates=rates[site_rate_idx.cpu().numpy()], t=t)


def score_mutants_gtr(model: SiteRmGtrModel, wt_focus_seq: str, mutants: Sequence[str],
                      offset_idx: int = 1, device="cuda") -> np.ndarray:
    """The reference's scoring identity (compute_fitness.py:166-194): over
    the mutated sites, log expm(Q_i t)[x, y] - log expm(Q_i t)[x, x]."""
    return score_from_rate_matrices(model.rate_matrices, model.t, wt_focus_seq, mutants,
                                    alphabet=model.alphabet, offset_idx=offset_idx,
                                    device=device)


def score_from_rate_matrices(rate_matrices: np.ndarray, t: float, wt_focus_seq: str,
                             mutants: Sequence[str], alphabet: str = AA20,
                             offset_idx: int = 1, device="cuda") -> np.ndarray:
    """Score with per-site rate matrices (L, q, q), e.g. converted CherryML
    models: ``torch.linalg.matrix_exp`` of Q_i t on ``device`` in the
    matrices' dtype. The WT letters are not checked, as in the JAX
    function."""
    dev = resolve_device(device)
    with no_tf32():
        p = torch.linalg.matrix_exp(torch.as_tensor(np.asarray(rate_matrices) * t, device=dev))
    logp = np.log(np.maximum(p.cpu().numpy(), 1e-30))
    return _score_log_tables(logp, alphabet, None, mutants, offset_idx)
