"""Kermut in PyTorch: Gaussian-process regression over mutation kernels
(counterpart of proteingym_tpu/models/kermut.py; ref
proteingym/baselines/kermut/kermut/model/kernel.py:15-120, gp.py:13-100,
data/data_utils.py:127-145).

  k_mut(m, m') = exp(-l_h Hellinger(p[pos_m], p[pos_m']))
               * exp(-l_d ||x[pos_m] - x[pos_m']||)
               * exp(-l_p |log p(aa_m | pos_m) - log p(aa_m' | pos_m')|)
  k_1(x, x')   = h_scale * sum over the mutation pairs of k_mut
  k            = sigmoid(alpha) k_1 + (1 - sigmoid(alpha)) RBF(embeddings)
                 when embeddings are given
  mean(x)      = mean_const + zero_shot_scale * zero_shot(x)

The hyperparameters (softplus-parameterised) maximise the marginal
likelihood through a Cholesky, Adam at lr 0.1. Everything is float32, as
the JAX CLI runs it (x64 is off there). The distance term gathers from an
(L, L) table built once from the same float32 coordinates, where the JAX
package forms an (n, D, m, D, 3) difference: the values are the same norms
of the same vectors, and the memory is O(L^2) instead.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from proteingym_tpu_torch.devices import resolve_device

AA20 = "ACDEFGHIKLMNPQRSTVWY"
HYPER_INIT = {"h_scale": 1.0, "h_lengthscale": 1.0, "d_lengthscale": 1.0, "p_lengthscale": 1.0,
              "alpha": 0.5, "rbf_lengthscale": 1.0, "zero_shot_scale": 1.0, "mean_const": 0.0,
              "noise": 0.1}


def hellinger_distance(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(n, 20) x (m, 20) -> (n, m), sqrt(0.5 * sum (sqrt p - sqrt q)^2)."""
    sp = np.sqrt(p)[:, None, :]
    sq = np.sqrt(q)[None, :, :]
    return np.sqrt(0.5 * np.sum((sp - sq) ** 2, axis=-1))


def encode_variants(mutants, max_depth: Optional[int] = None, offset_idx: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Mutant strings -> padded (positions, tokens, valid) arrays; a WT row
    ('' or 'WT') has no valid mutation."""
    aa_idx = {a: i for i, a in enumerate(AA20)}
    parsed = []
    for m in mutants:
        toks = []
        if isinstance(m, str) and m and m.upper() != "WT":
            for t in m.split(":"):
                toks.append((int(t[1:-1]) - offset_idx, aa_idx[t[-1]]))
        parsed.append(toks)
    depth = max_depth or max(1, max(len(p) for p in parsed))
    n = len(parsed)
    pos = np.zeros((n, depth), np.int32)
    tok = np.zeros((n, depth), np.int32)
    valid = np.zeros((n, depth), bool)
    for i, toks in enumerate(parsed):
        for j, (p, a) in enumerate(toks[:depth]):
            pos[i, j], tok[i, j], valid[i, j] = p, a, True
    return pos, tok, valid


@dataclasses.dataclass
class KermutData:
    """The per-assay tables the kernel conditions on (float64 numpy, as the
    JAX package keeps them; cast to float32 on the device at use)."""

    conditional_probs: np.ndarray  # (L, 20)
    coords: np.ndarray  # (L, 3) CA
    hellinger: np.ndarray  # (L, L)
    log_probs: np.ndarray  # (L, 20)

    @classmethod
    def build(cls, conditional_probs: np.ndarray, coords: np.ndarray):
        probs = np.asarray(conditional_probs, np.float64)
        return cls(conditional_probs=probs, coords=np.asarray(coords, np.float64),
                   hellinger=hellinger_distance(probs, probs),
                   log_probs=np.log(np.clip(probs, 1e-12, None)))


class DeviceTables:
    """A KermutData's float32 tables on ``device``: Hellinger, log-probs,
    and the (L, L) CA distances, each the norm of the float32 difference of
    two float32 coordinates."""

    def __init__(self, data: KermutData, device):
        device = resolve_device(device)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.hellinger = f32(data.hellinger)
        self.log_probs = f32(data.log_probs)
        coords = f32(data.coords)
        self.distance = torch.linalg.vector_norm(coords[:, None, :] - coords[None, :, :], dim=-1)


def init_hypers(device) -> Dict[str, torch.Tensor]:
    """The raw hyperparameters (positive ones through softplus)."""
    return {k: torch.tensor(v, dtype=torch.float32, device=device) for k, v in HYPER_INIT.items()}


def _as_tensors(variants, device):
    return tuple(torch.as_tensor(np.asarray(t), device=device) for t in variants)


def mutation_kernel(hypers, tables: DeviceTables, a, b) -> torch.Tensor:
    """a, b: (positions, tokens, valid) tensors -> the (n, m) Gram block."""
    pa, ta, va = a
    pb, tb, vb = b
    pa, pb, ta, tb = pa.long(), pb.long(), ta.long(), tb.long()
    hn = tables.hellinger[pa][:, :, pb]  # (n, D, m, D)
    k_hn = torch.exp(-F.softplus(hypers["h_lengthscale"]) * hn)
    dist = tables.distance[pa][:, :, pb]
    k_d = torch.exp(-F.softplus(hypers["d_lengthscale"]) * dist)
    lp_a = tables.log_probs[pa, ta]  # (n, D)
    lp_b = tables.log_probs[pb, tb]
    k_p = torch.exp(-F.softplus(hypers["p_lengthscale"])
                    * torch.abs(lp_a[:, :, None, None] - lp_b[None, None, :, :]))
    mask = va[:, :, None, None] & vb[None, None, :, :]
    k = torch.where(mask, k_hn * k_d * k_p, 0.0)
    return F.softplus(hypers["h_scale"]) * k.sum(dim=(1, 3))


def full_kernel(hypers, tables: DeviceTables, a, b, emb_a=None, emb_b=None) -> torch.Tensor:
    k = mutation_kernel(hypers, tables, a, b)
    if emb_a is not None and emb_b is not None:
        d2 = ((emb_a[:, None, :] - emb_b[None, :, :]) ** 2).sum(-1)
        k_rbf = torch.exp(-0.5 * d2 / F.softplus(hypers["rbf_lengthscale"]) ** 2)
        w = torch.sigmoid(hypers["alpha"])
        k = w * k + (1.0 - w) * k_rbf
    return k


def _mean(hypers, zero_shot):
    m = hypers["mean_const"]
    if zero_shot is not None:
        m = m + hypers["zero_shot_scale"] * zero_shot
    return m


def _chol_alpha(hypers, k, resid):
    n = resid.shape[0]
    k = k + (F.softplus(hypers["noise"]) + 1e-6) * torch.eye(n, device=k.device)
    chol = torch.linalg.cholesky(k)
    return chol, torch.cholesky_solve(resid[:, None], chol)[:, 0]


def neg_log_marginal_likelihood(hypers, tables: DeviceTables, train, y, zero_shot=None,
                                emb=None) -> torch.Tensor:
    k = full_kernel(hypers, tables, train, train, emb, emb)
    resid = y - _mean(hypers, zero_shot)
    chol, alpha = _chol_alpha(hypers, k, resid)
    n = y.shape[0]
    return (0.5 * resid @ alpha + torch.log(torch.diagonal(chol)).sum()
            + 0.5 * n * float(np.log(2 * np.pi)))


def _f32(x, device):
    return None if x is None else torch.as_tensor(np.asarray(x, np.float32), device=device)


def fit(data: KermutData, train, y: np.ndarray, zero_shot: Optional[np.ndarray] = None,
        emb: Optional[np.ndarray] = None, steps: int = 150, learning_rate: float = 0.1,
        device="cuda", tables: Optional[DeviceTables] = None) -> Dict[str, torch.Tensor]:
    """The hyperparameters that maximise the marginal likelihood: ``steps``
    Adam steps (``optax.adam``'s update) from ``HYPER_INIT``."""
    tables = tables or DeviceTables(data, device)
    dev = tables.hellinger.device
    hypers = init_hypers(dev)
    for v in hypers.values():
        v.requires_grad_(True)
    yt, zs, embt = _f32(y, dev), _f32(zero_shot, dev), _f32(emb, dev)
    train = _as_tensors(train, dev)
    opt = torch.optim.Adam(list(hypers.values()), lr=learning_rate, fused=dev.type == "cuda")
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        neg_log_marginal_likelihood(hypers, tables, train, yt, zs, embt).backward()
        opt.step()
    return {k: v.detach().requires_grad_(False) for k, v in hypers.items()}


@torch.no_grad()
def predict(hypers, data: KermutData, train, y: np.ndarray, test,
            zero_shot_train: Optional[np.ndarray] = None,
            zero_shot_test: Optional[np.ndarray] = None,
            emb_train: Optional[np.ndarray] = None, emb_test: Optional[np.ndarray] = None,
            device="cuda", tables: Optional[DeviceTables] = None) -> np.ndarray:
    """The posterior mean at the test variants."""
    tables = tables or DeviceTables(data, device)
    dev = tables.hellinger.device
    train, test = _as_tensors(train, dev), _as_tensors(test, dev)
    yt = _f32(y, dev)
    e_tr, e_te = _f32(emb_train, dev), _f32(emb_test, dev)
    k_tt = full_kernel(hypers, tables, train, train, e_tr, e_tr)
    k_st = full_kernel(hypers, tables, test, train, e_te, e_tr)
    resid = yt - _mean(hypers, _f32(zero_shot_train, dev))
    _, alpha = _chol_alpha(hypers, k_tt, resid)
    mean_test = (0.0 if zero_shot_test is None
                 else hypers["zero_shot_scale"] * _f32(zero_shot_test, dev))
    return (hypers["mean_const"] + mean_test + k_st @ alpha).cpu().numpy()


@torch.no_grad()
def conditional_probs_from_mpnn(model, coords: np.ndarray, sequence: str, n_orders: int = 4,
                                seed: int = 0) -> np.ndarray:
    """(L, 20) per-position conditionals: ProteinMPNN's teacher-forced
    decodes averaged over ``n_orders`` decoding orders (each the argsort of
    |default_rng(seed).standard_normal(L)|, one after another, as the JAX
    package draws them), all orders in one (n_orders, L) decode."""
    from proteingym_tpu_torch.models import protein_mpnn as mpnn

    dev = next(model.parameters()).device
    enc = mpnn.encode(model, torch.as_tensor(np.asarray(coords, np.float32), device=dev))
    length = len(sequence)
    rng = np.random.default_rng(seed)
    orders = np.stack([np.argsort(np.abs(rng.standard_normal(length)))
                       for _ in range(n_orders)]).astype(np.int64)
    toks = torch.as_tensor(mpnn.tokenize_sequence(sequence), device=dev)
    logp = mpnn.decode(model, enc, toks[None].expand(n_orders, -1),
                       torch.as_tensor(orders, device=dev))
    probs_each = torch.exp(logp).cpu().numpy().astype(np.float64)
    acc = np.zeros((length, probs_each.shape[-1]))
    for p in probs_each:
        acc += p
    probs = acc[:, :20] / n_orders
    return probs / probs.sum(axis=1, keepdims=True)
