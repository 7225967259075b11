"""The plain Geometric Vector Perceptron and the backbone features of the
structure models (counterpart of proteingym_tpu/ops/gvp.py).

A GVP maps scalar features s (..., s_in) and vector features V (..., v_in,
3) to

  Vh = W_h V                        (channel mixing, rotation-equivariant)
  s' = act(W_s [s ; ||Vh||])        (||.|| = sqrt(sum + 1e-8))
  V' = (W_v Vh) * sigmoid(W_g s')   (the gate read from the activated s')

The features, in numpy: per-residue dihedral and orientation features, and
per-edge distance and offset features over a k-nearest-neighbour graph
(``ops/gnn.knn_graph``). The drorlab GVP variant of S2F / S3F, whose norms
and gate differ, lives in ``models/s3f.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


class Gvp(nn.Module):
    """The JAX ``gvp_init`` / ``gvp_apply``: ``wh`` (v_in -> h) and ``wv`` (h
    -> v_out) without bias, ``ws`` (s_in + h -> s_out), and ``gate`` (s_out
    -> v_out) when ``vector_gate`` and v_out; h = max(v_in, v_out)."""

    def __init__(self, s_in: int, v_in: int, s_out: int, v_out: int, vector_gate: bool = True):
        super().__init__()
        h = max(v_in, v_out)
        self.wh = nn.Linear(v_in, h, bias=False)
        self.wv = nn.Linear(h, v_out, bias=False)
        self.ws = nn.Linear(s_in + h, s_out)
        self.gate = nn.Linear(s_out, v_out) if vector_gate and v_out else None

    def forward(self, s: torch.Tensor, v: torch.Tensor, activate: bool = True):
        """s (..., s_in), v (..., v_in, 3) -> (s (..., s_out), v (..., v_out, 3))."""
        vh = self.wh(v.transpose(-1, -2))  # (..., 3, h)
        s_out = self.ws(torch.cat([s, torch.sqrt((vh * vh).sum(-2) + 1e-8)], -1))
        if activate:
            s_out = torch.relu(s_out)
        v_out = self.wv(vh).transpose(-1, -2)
        if self.gate is not None:
            v_out = v_out * torch.sigmoid(self.gate(s_out))[..., None]
        return s_out, v_out


def gvp_params_from_jax(p) -> Dict[str, torch.Tensor]:
    """One JAX ``gvp_init`` dict (numpy leaves) in ``Gvp``'s names."""
    t = lambda a: torch.from_numpy(np.array(np.asarray(a, dtype=np.float32).T))  # noqa: E731
    sd = {"wh.weight": t(p["wh"]), "wv.weight": t(p["wv"]), "ws.weight": t(p["ws"]["w"]),
          "ws.bias": torch.from_numpy(np.array(p["ws"]["b"], dtype=np.float32))}
    if "gate" in p:
        sd["gate.weight"] = t(p["gate"]["w"])
        sd["gate.bias"] = torch.from_numpy(np.array(p["gate"]["b"], dtype=np.float32))
    return sd


def dihedral(p0, p1, p2, p3, floor: Optional[float] = None) -> np.ndarray:
    """The dihedral angles (radians) of the points p0-p3, each (..., 3).
    The middle bond is normalised by its length + 1e-8, or by its length
    clamped at ``floor`` when one is given: MULAN's JAX angles clamp at
    1e-9, the GVP features add 1e-8, and each is kept bit for bit."""
    b0, b1, b2 = p1 - p0, p2 - p1, p3 - p2
    norm = np.linalg.norm(b1, axis=-1, keepdims=True)
    b1n = b1 / (norm + 1e-8 if floor is None else np.maximum(norm, floor))
    v = b0 - (b0 * b1n).sum(-1, keepdims=True) * b1n
    w = b2 - (b2 * b1n).sum(-1, keepdims=True) * b1n
    return np.arctan2((np.cross(b1n, v) * w).sum(-1), (v * w).sum(-1))


def backbone_node_features(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(L, 4, 3) N/CA/C/O -> scalars (L, 6), the sin and cos of phi, psi and
    omega (0 where the chain ends), and vectors (L, 3, 3): the unit forward
    and backward CA directions and the N x C normal."""
    n, ca, c = coords[:, 0], coords[:, 1], coords[:, 2]
    L = coords.shape[0]
    phi, psi, omega = np.zeros(L), np.zeros(L), np.zeros(L)
    if L > 1:
        phi[1:] = dihedral(c[:-1], n[1:], ca[1:], c[1:])
        psi[:-1] = dihedral(n[:-1], ca[:-1], c[:-1], n[1:])
        omega[1:] = dihedral(ca[:-1], c[:-1], n[1:], ca[1:])
    scalars = np.stack([np.sin(phi), np.cos(phi), np.sin(psi), np.cos(psi),
                        np.sin(omega), np.cos(omega)], -1).astype(np.float32)

    def unit(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-8)

    fwd, bwd = np.zeros((L, 3)), np.zeros((L, 3))
    fwd[:-1] = unit(ca[1:] - ca[:-1])
    bwd[1:] = unit(ca[:-1] - ca[1:])
    side = unit(np.cross(n - ca, c - ca))
    vectors = np.stack([fwd, bwd, side], 1).astype(np.float32)
    return scalars, vectors


def backbone_edge_features(coords: np.ndarray, e_idx: np.ndarray,
                           num_rbf: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Edges of the (L, K) neighbour indices ``e_idx``: scalars (L, K,
    num_rbf + 3), the RBF of the CA distance over [0, 20] A and the
    sequence offset as sin, cos (period 20 pi) and clipped to +-32 over 32;
    vectors (L, K, 1, 3), the unit CA -> neighbour direction."""
    ca = coords[:, 1]
    L, K = e_idx.shape
    rel = ca[e_idx] - ca[:, None]
    d = np.linalg.norm(rel, axis=-1)
    mu = np.linspace(0.0, 20.0, num_rbf)
    sigma = 20.0 / num_rbf
    rbf = np.exp(-(((d[..., None] - mu) / sigma) ** 2))
    offset = (e_idx - np.arange(L)[:, None]).astype(np.float32)
    pos_feat = np.stack([np.sin(offset / 10.0), np.cos(offset / 10.0),
                         np.clip(offset, -32, 32) / 32.0], -1)
    scalars = np.concatenate([rbf, pos_feat], -1).astype(np.float32)
    vectors = (rel / (d[..., None] + 1e-8))[:, :, None, :].astype(np.float32)
    return scalars, vectors
