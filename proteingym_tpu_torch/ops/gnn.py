"""Graph ops for the structure models (counterpart of
proteingym_tpu/ops/gnn.py): the k-nearest-neighbour graph and the
E(n)-equivariant GNN (EGNN) of ProtSSN's surrogate (ref
protssn/src/module/egnn/egnn_pytorch.py:148-330):

  m_ij = phi_e([h_i, h_j, ||x_i - x_j||^2])
  x_i' = x_i + sum_j (x_i - x_j) / (||x_i - x_j|| + 1) * phi_x(m_ij)   [optional]
  h_i' = h_i + phi_h([h_i, sum_j m_ij])

over (L, K) neighbour indices, as dense (L, K, D) gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device, seeded_generator
from proteingym_tpu_torch.models.state_dict import copy_state_dict


def knn_graph(coords: torch.Tensor, k: int) -> torch.Tensor:
    """(L, 3) coordinates -> (L, min(k, L - 1)) neighbour indices, nearest
    first, self excluded. Squared distances are summed one coordinate at a
    time in the input dtype (so every device ranks the same numbers), self
    is pushed out by 1e9, and a stable ascending sort breaks ties to the
    lower index, as ``jax.lax.top_k`` does."""
    L = coords.shape[0]
    diff = coords[:, None] - coords[None]
    d2 = diff[..., 0] ** 2 + diff[..., 1] ** 2 + diff[..., 2] ** 2
    d2 = d2 + torch.eye(L, dtype=d2.dtype, device=d2.device) * 1e9
    return torch.sort(d2, dim=-1, stable=True).indices[:, :min(k, L - 1)]


@dataclasses.dataclass(frozen=True)
class EgnnConfig:
    node_dim: int
    hidden_dim: int = 64
    num_layers: int = 4
    k_neighbors: int = 16
    update_coords: bool = False
    out_dim: Optional[int] = None  # readout head size (e.g. 20 amino acids)


def _mlp(dims):
    return nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))


def _apply_mlp(x, layers, final_act=False):
    for i, lin in enumerate(layers):
        x = lin(x)
        if i + 1 < len(layers) or final_act:
            x = F.silu(x)
    return x


class EgnnLayer(nn.Module):
    def __init__(self, c: EgnnConfig):
        super().__init__()
        d, h = c.node_dim, c.hidden_dim
        self.edge_mlp = _mlp([2 * d + 1, h, h])
        self.node_mlp = _mlp([d + h, h, d])
        self.coors_mlp = _mlp([h, h, 1]) if c.update_coords else None


class Egnn(nn.Module):
    """The JAX ``egnn_init`` / ``egnn_apply`` / ``egnn_readout`` as a module:
    ``layers.{i}.edge_mlp``, ``node_mlp`` (and ``coors_mlp`` with
    ``update_coords``), SiLU MLPs, and ``head`` when ``out_dim`` is set."""

    def __init__(self, c: EgnnConfig):
        super().__init__()
        self.config = c
        self.layers = nn.ModuleList(EgnnLayer(c) for _ in range(c.num_layers))
        self.head = _mlp([c.node_dim, c.hidden_dim, c.out_dim]) if c.out_dim is not None else None

    def forward(self, feats: torch.Tensor, coords: torch.Tensor,
                neighbors: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """feats (L, D), coords (L, 3) -> (feats', coords')."""
        if neighbors is None:
            neighbors = knn_graph(coords, self.config.k_neighbors)
        h, x = feats, coords
        for layer in self.layers:
            rel = x[:, None] - x[neighbors]  # (L, K, 3)
            d2 = (rel ** 2).sum(-1, keepdim=True)
            h_j = h[neighbors]
            h_i = h[:, None].expand_as(h_j)
            m = _apply_mlp(torch.cat([h_i, h_j, d2], -1), layer.edge_mlp, final_act=True)
            if layer.coors_mlp is not None:
                w = _apply_mlp(m, layer.coors_mlp)
                x = x + (rel / (d2.sqrt() + 1.0) * w).sum(-2)
            h = h + _apply_mlp(torch.cat([h, m.sum(-2)], -1), layer.node_mlp)
        return h, x

    def readout(self, feats: torch.Tensor) -> torch.Tensor:
        return _apply_mlp(feats, self.head)


def _empty_egnn(c: EgnnConfig, device) -> Egnn:
    with torch.device("meta"):
        model = Egnn(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def egnn_init_random(c: EgnnConfig, seed: int = 0, device="cuda") -> Egnn:
    """Seeded random weights with the JAX ``egnn_init`` distribution (the
    draws differ): each (in, out) matrix N(0, 2 / in), zero biases."""
    model = _empty_egnn(c, device)
    dev = next(model.parameters()).device
    gen = seeded_generator(seed, dev)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev)
                    * float(np.sqrt(2.0 / p.shape[1])))
    return model


def egnn_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``egnn_init`` pytree (numpy leaves) in the module's names:
    (in, out) matrices become (out, in) ``Linear`` weights."""
    sd = {}

    def mlp(prefix, layers):
        for j, p in enumerate(layers):
            sd[f"{prefix}.{j}.weight"] = torch.from_numpy(np.array(np.asarray(p["w"]).T,
                                                                   dtype=np.float32))
            sd[f"{prefix}.{j}.bias"] = torch.from_numpy(np.array(p["b"], dtype=np.float32))

    for i, layer in enumerate(params["layers"]):
        for name, mlps in layer.items():
            mlp(f"layers.{i}.{name}", mlps)
    if "head" in params:
        mlp("head", params["head"])
    return sd


def egnn_load_state_dict(state_dict, c: EgnnConfig, device="cuda") -> Egnn:
    return copy_state_dict(_empty_egnn(c, device), state_dict, "EGNN")
