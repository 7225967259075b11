"""Potts (EVmutation) and site-independent statistical-energy models
(counterpart of proteingym_tpu/models/potts.py; ref proteingym/baselines/
EVmutation/score_mutants.py:8-62, calculations.py:55-179):

  H(x)  = sum_i h_i(x_i) + sum_{i<j} J_ij(x_i, x_j)
  score = dE = H(mutant) - H(wild type)

computed on the device in float64 through the wild-type background

  G[p, a] = h[p, a] + sum_{j != p} J[p, j, a, wt_j]

so a single mutant is G[p, t] - G[p, f], and a mutant of depth D adds the
D^2 pair corrections J[t, t'] - J[t, f'] - J[f, t'] + J[f, f'].

Also: the plmc v2 ``.model`` reader and writer (the format of
EVcouplings' CouplingsModel; NumPy), the weighted-frequency
site-independent model, and the pseudolikelihood Potts trainer: full-batch
Adam on the device in float32 (without TF32), whose hot operation is the
(N, L*q) x (L*q, L*q) product of the one-hot alignment with the couplings.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from proteingym_tpu_torch.data.mutants import parse_mutant
from proteingym_tpu_torch.devices import no_tf32, resolve_device


@dataclasses.dataclass
class PottsModel:
    """Couplings model over an alphabet (usually '-ACDE...')."""

    h: np.ndarray  # (L, q) fields
    J: np.ndarray  # (L, L, q, q) couplings, symmetric: J[i, j] == J[j, i].T
    alphabet: str
    index_list: np.ndarray  # (L,) positions in target-sequence numbering
    target_seq: str  # focus sequence (length L)
    f_i: Optional[np.ndarray] = None  # (L, q) single-site frequencies
    theta: float = 0.2
    neff: float = 0.0
    weights: Optional[np.ndarray] = None
    # the pseudolikelihood trainer's loss at each step (train_potts_plm)
    losses: Optional[np.ndarray] = None

    def __post_init__(self):
        self._aa_to_idx = {a: i for i, a in enumerate(self.alphabet)}
        self._pos_to_idx = {int(p): i for i, p in enumerate(self.index_list)}

    @property
    def L(self) -> int:
        return self.h.shape[0]

    @property
    def q(self) -> int:
        return self.h.shape[1]

    def encode(self, seq: str) -> np.ndarray:
        return np.asarray([self._aa_to_idx[c] for c in seq], dtype=np.int64)

    def to_independent_model(self) -> "PottsModel":
        """Fields log f_i, couplings zero (EVcouplings' to_independent_model:
        the 'Site_Independent' leaderboard entry)."""
        with np.errstate(divide="ignore"):
            h = np.log(np.maximum(self.f_i, 0))
        return PottsModel(h=h, J=np.zeros_like(self.J), alphabet=self.alphabet,
                          index_list=self.index_list, target_seq=self.target_seq,
                          f_i=self.f_i, theta=self.theta, neff=self.neff,
                          weights=self.weights)

    def _tensors(self, device):
        dev = resolve_device(device)
        f64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64), device=dev)
        return (f64(self.h), f64(self.J),
                torch.as_tensor(self.encode(self.target_seq), device=dev))

    def wt_background(self, device="cuda") -> np.ndarray:
        """G[p, a] = h[p, a] + sum_{j != p} J[p, j, a, wt_j], float64 (L, q)."""
        return _wt_background(*self._tensors(device)).cpu().numpy()

    def delta_hamiltonians(self, mutants: Sequence[str], offset: int = 0, delim: str = ":",
                           device="cuda") -> np.ndarray:
        """dE of each mutant string (target-sequence numbering), float64.

        ``offset`` is added to every position before it is mapped into the
        model (ref score_mutants.py:62 passes -(MSA_start-1)). A mutation
        at a position outside the model, or with a letter outside the
        alphabet, makes the mutant NaN (ref calculations.py:62-67)."""
        out = np.full(len(mutants), np.nan, dtype=np.float64)
        pos, frm, to, valid, ok = self._encode_mutants(mutants, offset, delim)
        if not ok.any():
            return out
        h, J, wt = self._tensors(device)
        idx = lambda x: torch.as_tensor(x[ok], device=h.device)
        d = _delta_hamiltonian_batch(h, J, wt, idx(pos), idx(frm), idx(to), idx(valid))
        out[ok] = d.cpu().numpy()
        return out

    def _encode_mutants(self, mutants, offset, delim):
        parsed = [parse_mutant(m, delim=delim) for m in mutants]
        n, depth = len(mutants), max([1] + [len(p) for p in parsed])
        pos = np.zeros((n, depth), dtype=np.int64)
        frm = np.zeros((n, depth), dtype=np.int64)
        to = np.zeros((n, depth), dtype=np.int64)
        valid = np.zeros((n, depth), dtype=bool)
        ok = np.ones(n, dtype=bool)
        for i, muts in enumerate(parsed):
            for j, (f, p, t) in enumerate(muts):
                p = p + offset
                if p not in self._pos_to_idx or f not in self._aa_to_idx \
                        or t not in self._aa_to_idx:
                    ok[i] = False
                    break
                pos[i, j] = self._pos_to_idx[p]
                frm[i, j] = self._aa_to_idx[f]
                to[i, j] = self._aa_to_idx[t]
                valid[i, j] = True
        return pos, frm, to, valid, ok


def _wt_background(h, J, wt):
    """G (L, q) on the tensors' device. The j == p term J[p, p, a, wt_p] is
    zero in plmc models (no self-couplings)."""
    length = h.shape[0]
    return h + J[:, torch.arange(length, device=J.device), :, wt].sum(dim=0)


def _delta_hamiltonian_batch(h, J, wt, pos, frm, to, valid):
    """dE (N,) of (N, D) padded mutation arrays."""
    G = _wt_background(h, J, wt)
    d_single = torch.where(valid, G[pos, to] - G[pos, frm], 0.0).sum(dim=1)
    # pair corrections between mutated positions m < m'
    p_i, p_j = pos[:, :, None], pos[:, None, :]
    t_i, t_j = to[:, :, None], to[:, None, :]
    f_i, f_j = frm[:, :, None], frm[:, None, :]
    corr = J[p_i, p_j, t_i, t_j] - J[p_i, p_j, t_i, f_j] - J[p_i, p_j, f_i, t_j] \
        + J[p_i, p_j, f_i, f_j]
    steps = torch.arange(pos.shape[1], device=pos.device)
    pair_mask = valid[:, :, None] & valid[:, None, :] & (steps[:, None] < steps[None, :])
    return d_single + torch.where(pair_mask, corr, 0.0).sum(dim=(1, 2))


# ---------------------------------------------------------------------------
# plmc v2 binary .model files (EVcouplings' CouplingsModel format)
# ---------------------------------------------------------------------------

def read_plmc_model(path: str | Path, precision: str = "float32") -> PottsModel:
    """Read a plmc v2 ``.model`` file (EVmutation's pre-trained format).

    Layout: int32[5] (L, q, N_valid, N_invalid, num_iter); float[5]
    (theta, lambda_h, lambda_J, lambda_group, N_eff); the alphabet's
    characters; the weights; the target sequence's characters; int32
    index_list; f_i (L, q); h_i (L, q); then the f_ij blocks of all i < j,
    then the J_ij blocks of all i < j, in row-major pair order."""
    with open(path, "rb") as f:
        L, q, n_valid, n_invalid, _num_iter = np.fromfile(f, "int32", 5)
        theta, _lh, _lJ, _lg, neff = np.fromfile(f, precision, 5)
        alphabet = np.fromfile(f, "S1", q).astype("U1")
        weights = np.fromfile(f, precision, n_valid + n_invalid)
        target_seq = np.fromfile(f, "S1", L).astype("U1")
        index_list = np.fromfile(f, "int32", L)
        f_i = np.fromfile(f, precision, L * q).reshape(L, q)
        h_i = np.fromfile(f, precision, L * q).reshape(L, q)
        iu, ju = np.triu_indices(L, k=1)

        def read_pair_tensor():
            blocks = np.fromfile(f, precision, len(iu) * q * q).reshape(len(iu), q, q)
            out = np.zeros((L, L, q, q), dtype=np.float64)
            out[iu, ju] = blocks
            out[ju, iu] = np.transpose(blocks, (0, 2, 1))
            return out

        f_ij = read_pair_tensor()
        J_ij = read_pair_tensor()
    model = PottsModel(h=h_i.astype(np.float64), J=J_ij, alphabet="".join(alphabet),
                       index_list=index_list, target_seq="".join(target_seq),
                       f_i=f_i.astype(np.float64), theta=float(theta), neff=float(neff),
                       weights=weights.astype(np.float64))
    model._f_ij = f_ij
    return model


def write_plmc_model(model: PottsModel, path: str | Path, precision: str = "float32") -> None:
    """Write ``model`` in the layout ``read_plmc_model`` reads (f_ij zero
    unless the model was read with them)."""
    L, q = model.L, model.q
    weights = model.weights if model.weights is not None else np.ones(1, dtype=np.float64)
    f_ij = getattr(model, "_f_ij", None)
    if f_ij is None:
        f_ij = np.zeros((L, L, q, q))
    iu, ju = np.triu_indices(L, k=1)
    with open(path, "wb") as f:
        np.asarray([L, q, len(weights), 0, 100], dtype="int32").tofile(f)
        np.asarray([model.theta, 0.01, 0.01, 0.0, model.neff], dtype=precision).tofile(f)
        np.frombuffer(model.alphabet.encode("ascii"), dtype="S1").tofile(f)
        weights.astype(precision).tofile(f)
        np.frombuffer(model.target_seq.encode("ascii"), dtype="S1").tofile(f)
        np.asarray(model.index_list).astype("int32").tofile(f)
        model.f_i.astype(precision).tofile(f)
        model.h.astype(precision).tofile(f)
        f_ij[iu, ju].astype(precision).tofile(f)
        np.asarray(model.J)[iu, ju].astype(precision).tofile(f)


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

def _site_frequencies(matrix: np.ndarray, weights: np.ndarray, q: int) -> np.ndarray:
    """Weighted single-site frequencies (L, q), float64, by one weighted
    ``bincount`` (no (N, L, q) one-hot)."""
    matrix = np.asarray(matrix, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float64)
    n, length = matrix.shape
    cols = np.broadcast_to(np.arange(length) * q, (n, length))
    counts = np.bincount((cols + matrix).ravel(), weights=np.repeat(weights, length),
                         minlength=length * q).reshape(length, q)
    return counts / weights.sum()


def train_site_independent(
    matrix: np.ndarray,
    weights: np.ndarray,
    alphabet: str,
    index_list: np.ndarray,
    target_seq: str,
    pseudocount: float = 0.5,
    theta: float = 0.2,
) -> PottsModel:
    """The weighted single-site frequency model, h = log((1 - lam) f +
    lam / q) with lam = pseudocount / Neff: a prior whose strength is
    relative to the effective sample size. ``matrix``: (N, L) codes over
    ``alphabet``; ``weights``: (N,) sequence weights."""
    weights = np.asarray(weights, dtype=np.float64)
    length, q = matrix.shape[1], len(alphabet)
    f_i = _site_frequencies(matrix, weights, q)
    lam = pseudocount / weights.sum()
    h = np.log((1 - lam) * f_i + lam / q)
    return PottsModel(h=h, J=np.zeros((length, length, q, q)), alphabet=alphabet,
                      index_list=np.asarray(index_list), target_seq=target_seq, f_i=f_i,
                      theta=theta, neff=float(weights.sum()), weights=weights)


def _plm_loss(h, P, onehot, codes, weights, lambda_h, lambda_j, off_diagonal):
    """Weighted pseudolikelihood with L2 regularisation, float32.

    The couplings live in P (L*q, L*q), P[(i, a), (j, b)] = J[i, j, a, b];
    symmetrising J (J[i, j, a, b] <- (J[i, j, a, b] + J[j, i, b, a]) / 2)
    is then P <- (P + P^T) / 2, and the zeroed diagonal is a block mask.
    The conditional logits of site i given the rest are h[i] +
    sum_j J[i, j, :, x_j]: one product of the (N, L*q) one-hot with the
    symmetric couplings."""
    n, length = codes.shape
    S = 0.5 * (P + P.T) * off_diagonal
    logits = h.reshape(1, -1) + onehot @ S
    logp = torch.log_softmax(logits.view(n, length, -1), dim=-1)
    ll = logp.gather(-1, codes[..., None]).sum(dim=(1, 2))
    nll = -(weights * ll).sum() / weights.sum()
    return nll + lambda_h * (h ** 2).sum() + lambda_j * 0.5 * (S ** 2).sum()


def train_potts_plm(
    matrix: np.ndarray,
    weights: np.ndarray,
    alphabet: str,
    index_list: np.ndarray,
    target_seq: str,
    lambda_h: float = 0.01,
    lambda_j: float = 0.01,
    steps: int = 300,
    learning_rate: float = 0.05,
    theta: float = 0.2,
    device="cuda",
) -> PottsModel:
    """Pseudolikelihood Potts trainer (plmc's role): full-batch Adam
    (``torch.optim.Adam`` with its defaults, the update of ``optax.adam``)
    from zero fields and couplings, autograd through plain tensor ops on
    ``device``. The loss stays on the device between steps and is read
    back once, at the end, into ``model.losses`` (the loss before each
    update)."""
    dev = resolve_device(device)
    n, length = matrix.shape
    q = len(alphabet)
    codes = torch.as_tensor(np.asarray(matrix, dtype=np.int64), device=dev)
    onehot = torch.zeros(n, length * q, device=dev)
    onehot.scatter_(1, codes + torch.arange(length, device=dev) * q, 1.0)
    w = torch.as_tensor(np.asarray(weights, dtype=np.float32), device=dev)
    blocks = 1.0 - torch.eye(length, device=dev)
    off_diagonal = blocks[:, None, :, None].expand(length, q, length, q).reshape(
        length * q, length * q)
    h = torch.zeros(length, q, device=dev, requires_grad=True)
    P = torch.zeros(length * q, length * q, device=dev, requires_grad=True)
    opt = torch.optim.Adam([h, P], lr=learning_rate)
    losses = torch.empty(steps, device=dev)
    with no_tf32():
        for step in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = _plm_loss(h, P, onehot, codes, w, lambda_h, lambda_j, off_diagonal)
            loss.backward()
            opt.step()
            losses[step] = loss.detach()
    del onehot, off_diagonal, opt
    with torch.no_grad():
        J = P.detach().double().view(length, q, length, q).permute(0, 2, 1, 3)
        J = 0.5 * (J + J.permute(1, 0, 3, 2))
        J[torch.arange(length), torch.arange(length)] = 0.0
        J = J.cpu().numpy()
    weights = np.asarray(weights)
    return PottsModel(h=h.detach().double().cpu().numpy(), J=J, alphabet=alphabet,
                      index_list=np.asarray(index_list), target_seq=target_seq,
                      f_i=_site_frequencies(matrix, weights, q), theta=theta,
                      neff=float(weights.sum()), weights=weights,
                      losses=losses.cpu().numpy().astype(np.float64))
