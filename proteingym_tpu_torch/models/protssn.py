"""ProtSSN: frozen PLM embeddings through an EGNN over the CA graph
(counterpart of proteingym_tpu/models/protssn.py; ref
proteingym/baselines/protssn/compute_fitness.py, src/models.py,
src/module/egnn/).

Two implementations, as in the JAX package:

1. **The weight-compatible EGNN_Sparse stack** of the published
   ``protssn_k{10,20,30}_h{512,768,1280}.pt`` files (``ProtssnEgnnConfig``
   down): the cutoff / k-NN CA graph with its 93 edge features (ref
   src/dataset/mutant_dataset.py:335-482), built on the host in float64
   numpy with numpy's default ``argsort``, as the JAX function builds it
   (a stable sort or a device top-k would pick other neighbours among the
   ideal helix's ties); the dataset statistics' normalisation (ref
   src/utils/dataset_utils.py:161-187); and ``ProtssnEgnn``, the stack in
   the published names (``mpnn_layes.{i}.edge_mlp.{0,3}``,
   ``node_mlp.{0,3}``, ``lin``; ``GNN_model.`` optional). Messages
   [feats[dst], feats[src], edge features, squared distance] are summed at
   ``dst`` (``index_add_``); coordinates never move.
2. **The surrogate** (``ProtssnConfig``): the k-NN EGNN of ``ops/gnn.py``
   with a 20-way readout, scored as log p(mt) - log p(wt).

Everything runs in float32; the scorer runs inside ``devices.no_tf32()``.
``train_denoising`` trains the surrogate on ProtSSN's denoising objective,
as the JAX function does (no CLI caller in either package).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import adam, resolve_device, seeded_generator
from proteingym_tpu_torch.models import esm2
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.ops.gnn import Egnn, EgnnConfig, egnn_init_random, knn_graph

AA20 = "ACDEFGHIKLMNPQRSTVWY"


# ---------------------------------------------------------------------------
# The surrogate: ESM embeddings + the k-NN EGNN
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ProtssnConfig:
    node_dim: int = 1280  # ESM2-650M embedding width
    hidden_dim: int = 512
    num_layers: int = 6
    k_neighbors: int = 20

    def egnn(self) -> EgnnConfig:
        return EgnnConfig(node_dim=self.node_dim, hidden_dim=self.hidden_dim,
                          num_layers=self.num_layers, k_neighbors=self.k_neighbors,
                          update_coords=False, out_dim=len(AA20))


def init_params(c: ProtssnConfig, seed: int = 0, device="cuda") -> Egnn:
    return egnn_init_random(c.egnn(), seed=seed, device=device)


@torch.no_grad()
def logits(model: Egnn, c: ProtssnConfig, embeddings: torch.Tensor,
           ca_coords: torch.Tensor) -> torch.Tensor:
    """(L, node_dim) embeddings + (L, 3) CA coordinates -> (L, 20) log-probs."""
    neighbors = knn_graph(ca_coords, c.k_neighbors)
    h, _ = model(embeddings, ca_coords, neighbors)
    return torch.log_softmax(model.readout(h), -1)


@torch.no_grad()
def esm_embeddings(esm_model: esm2.EsmModel, sequence: str) -> torch.Tensor:
    """(L, D) float32: the trunk's final-layer representation (after its last
    layer norm), BOS and EOS trimmed."""
    dev = esm_model.embed_tokens.weight.device
    tokens = torch.as_tensor(esm2.ALPHABET.tokenize(sequence)[None], device=dev)
    _, reps = esm_model(tokens, return_representations=True)
    return reps[max(reps)][0, 1:1 + len(sequence)].float()


def score_mutants(model: Egnn, c: ProtssnConfig, embeddings: torch.Tensor,
                  ca_coords: torch.Tensor, sequence: str, mutants: Sequence[str],
                  offset_idx: int = 1) -> np.ndarray:
    """Sum over mutated positions of log p(mt) - log p(wt) (ref
    protssn/compute_fitness.py)."""
    table = logits(model, c, embeddings, ca_coords).cpu().numpy()
    aa_idx = {a: i for i, a in enumerate(AA20)}
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        for tok in m.split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if sequence[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            out[i] += table[pos, aa_idx[mt]] - table[pos, aa_idx[wt]]
    return out


def train_denoising(
    model: Egnn,
    c: ProtssnConfig,
    embeddings,
    ca_coords,
    native_tokens,
    steps: int = 100,
    learning_rate: float = 1e-3,
    noise_prob: float = 0.25,
    seed: int = 0,
    noise=None,
) -> Egnn:
    """ProtSSN-style denoising objective: predict the native AA at every
    position from (noised) embeddings + structure (the JAX
    ``train_denoising``). Each step zeroes the embeddings of the nodes of a
    Bernoulli(``noise_prob``) draw and takes one Adam step
    (``devices.adam``, optax.adam's update) on the mean NLL of
    ``native_tokens`` (indices into AA20) over the k-NN graph of
    ``ca_coords``. ``noise``: the (steps, L, 1) bool draws to use (a test
    hands in JAX's), else drawn from ``seeded_generator(seed)`` on the
    model's device. Trains ``model`` in place and returns it, its losses in
    ``model.losses`` (a float32 numpy array, read once at the end)."""
    dev = next(model.parameters()).device
    emb = torch.as_tensor(np.asarray(embeddings), dtype=torch.float32, device=dev) \
        if not torch.is_tensor(embeddings) else embeddings.to(dev, torch.float32)
    coords = torch.as_tensor(np.asarray(ca_coords, dtype=np.float32), device=dev)
    targets = torch.as_tensor(np.asarray(native_tokens), dtype=torch.long, device=dev)
    neighbors = knn_graph(coords, c.k_neighbors)
    gen = seeded_generator(seed, dev) if noise is None else None
    if noise is not None:
        noise = torch.as_tensor(np.asarray(noise), dtype=torch.bool, device=dev)
    model.requires_grad_(True)
    optimizer = adam(model, learning_rate)
    losses = []
    for i in range(steps):
        drop = noise[i] if noise is not None else \
            torch.rand((emb.shape[0], 1), generator=gen, device=dev) < noise_prob
        h, _ = model(torch.where(drop, torch.zeros_like(emb), emb), coords, neighbors)
        logp = torch.log_softmax(model.readout(h), -1)
        loss = -logp.gather(-1, targets[:, None])[:, 0].mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    model.requires_grad_(False)
    model.losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0, np.float32)
    return model


# ---------------------------------------------------------------------------
# The weight-compatible ProtSSN (published protssn_k{k}_h{h}.pt)
# ---------------------------------------------------------------------------

AA_PROTSSN = "ARNDCQEGHILKMFPSTWYV"  # amino_acids_type order


@dataclasses.dataclass(frozen=True)
class ProtssnEgnnConfig:
    name: str = "protssn_k20_h512"
    input_dim: int = 1280        # PLM hidden size (ESM2-650M)
    m_dim: int = 512             # hidden_channels h
    n_layers: int = 6
    edge_attr_dim: int = 93
    k_neighbors: int = 20        # c_alpha_max_neighbors
    cutoff: float = 30.0
    seq_dist_cut: int = 64
    out_dim: int = 20


PROTSSN_PRESETS = {
    f"protssn_k{k}_h{h}": ProtssnEgnnConfig(name=f"protssn_k{k}_h{h}", m_dim=h, k_neighbors=k)
    for k in (10, 20, 30)
    for h in (512, 768, 1280)
}


def build_calpha_graph(coords: np.ndarray, k: int, cutoff: float = 30.0,
                       seq_dist_cut: int = 64):
    """(L, >=3, 3) N/CA/C coordinates -> (src, dst, edge_attr (E, 93), CA
    float32), as the reference constructs it (mutant_dataset.py:335-460): the
    cutoff graph capped at the k nearest (self excluded, at least one
    neighbour), edge features [sequence-distance one-hot (65), RBF (15),
    contact (1), local-frame orientation (12)]. A copy of the JAX function:
    float64, numpy's default ``argsort``, the orientation computed from CA
    rounded to float32."""
    n, ca, c = (coords[:, 0].astype(np.float64), coords[:, 1].astype(np.float64),
                coords[:, 2].astype(np.float64))
    L = len(ca)
    diff = ca[:, None] - ca[None, :]
    D = np.sqrt((diff ** 2).sum(-1))
    src_list, dst_list, dist_list = [], [], []
    for i in range(L):
        dst = list(np.where(D[i] < cutoff)[0])
        dst.remove(i)
        if k is not None and len(dst) > k:
            dst = list(np.argsort(D[i]))[1:k + 1]
        if len(dst) == 0:
            dst = list(np.argsort(D[i]))[1:2]
        src_list.extend([i] * len(dst))
        dst_list.extend(dst)
        dist_list.extend(list(D[i, dst]))
    src = np.asarray(src_list, np.int32)
    dst = np.asarray(dst_list, np.int32)
    dist = np.asarray(dist_list)

    def _norm(v):
        return v / np.linalg.norm(v, axis=-1, keepdims=True)

    # local frames: u = N - CA, t = C - CA, n = u x t, v = n x u
    u_i = _norm(n - ca)
    t_i = _norm(c - ca)
    n_i = _norm(np.cross(u_i, t_i))
    v_i = np.cross(n_i, u_i)

    seq_d = np.minimum(np.abs(src - dst), seq_dist_cut)
    seq_edge = np.eye(seq_dist_cut + 1, dtype=np.float32)[seq_d]
    scales = np.asarray([1.5 ** x for x in range(15)])  # distance_featurizer, divisor 4
    dist_fea = np.exp(-((dist[:, None] / 4.0) ** 2) / scales).astype(np.float32)
    contact = (dist <= 8).astype(np.float32)[:, None]
    ca32 = ca.astype(np.float32).astype(np.float64)
    basis = np.stack([n_i[dst], u_i[dst], v_i[dst]], axis=1)  # (E, 3, 3), the dst frame
    p_ij = np.einsum("eij,ej->ei", basis, ca32[src] - ca32[dst])
    q_ij = np.einsum("eij,ej->ei", basis, n_i[src])
    k_ij = np.einsum("eij,ej->ei", basis, u_i[src])
    t_ij = np.einsum("eij,ej->ei", basis, v_i[src])
    ori = np.concatenate([p_ij, q_ij, k_ij, t_ij], -1).astype(np.float32)
    edge_attr = np.concatenate([seq_edge, dist_fea, contact, ori], -1)
    return src, dst, edge_attr, ca.astype(np.float32)


def apply_norm_stats(pos: np.ndarray, edge_attr: np.ndarray, stats,
                     skip_edge_attr: int = 64, safe_domi: float = 1e-10):
    """NormalizeProtein for the EGNN's inputs (dataset_utils.py:179-187): pos
    centred and divided by mean(pos_std); edge_attr[:, 64:] standardised.
    The skip boundary cuts into the 65-wide one-hot, a reference quirk
    kept."""
    pos = pos - pos.mean(0, keepdims=True)
    pos = pos / (float(np.mean(stats["pos_std"])) + safe_domi)
    edge_attr = edge_attr.copy()
    mean = np.asarray(stats["edge_attr_mean"], np.float32)[skip_edge_attr:]
    std = np.asarray(stats["edge_attr_std"], np.float32)[skip_edge_attr:]
    edge_attr[:, skip_edge_attr:] = (edge_attr[:, skip_edge_attr:] - mean) / (std + safe_domi)
    return pos.astype(np.float32), edge_attr


def identity_norm_stats() -> Dict[str, np.ndarray]:
    """The statistics without a file: centring only (the JAX scorer's
    documented fallback)."""
    return {"pos_std": np.ones(3, np.float32), "edge_attr_mean": np.zeros(93, np.float32),
            "edge_attr_std": np.ones(93, np.float32) - 1e-10}


def load_norm_stats(path) -> Dict[str, np.ndarray]:
    """Read a published ``cath_k{k}_mean_attr.pt`` statistics file."""
    dic = torch.load(path, map_location="cpu", weights_only=False)
    return {k: np.asarray(v) for k, v in dic.items()}


class EgnnSparseLayer(nn.Module):
    """One EGNN_Sparse layer (ref egnn_pytorch_geometric.py:98-299, embedding
    False, residual False, mlp_num 2, aggr add, update_coors False): edge_mlp
    = [Linear, Dropout, SiLU, Linear, SiLU], node_mlp = [Linear, Dropout,
    SiLU, Linear], dropout an identity when scoring."""

    def __init__(self, c: ProtssnEgnnConfig):
        super().__init__()
        edge_in = c.edge_attr_dim + 1 + 2 * c.input_dim
        self.edge_mlp = nn.Sequential(nn.Linear(edge_in, 2 * edge_in), nn.Identity(), nn.SiLU(),
                                      nn.Linear(2 * edge_in, c.m_dim), nn.SiLU())
        self.node_mlp = nn.Sequential(nn.Linear(c.input_dim + c.m_dim, 2 * c.input_dim),
                                      nn.Identity(), nn.SiLU(),
                                      nn.Linear(2 * c.input_dim, c.input_dim))

    def forward(self, feats, ea, src, dst):
        m = self.edge_mlp(torch.cat([feats[dst], feats[src], ea], -1))
        m_i = torch.zeros(feats.shape[0], m.shape[1], dtype=m.dtype,
                          device=m.device).index_add_(0, dst, m)  # aggr="add" at dst
        return feats + self.node_mlp(torch.cat([feats, m_i], -1))  # the internal residual


class ProtssnEgnn(nn.Module):
    """The published GNN: ``mpnn_layes`` and the readout ``lin``. (L,
    input_dim) PLM features, (L, 3) normalised positions, (E,) src and dst,
    (E, 93) normalised edge features -> (L, out_dim) logits."""

    def __init__(self, c: ProtssnEgnnConfig):
        super().__init__()
        self.config = c
        self.mpnn_layes = nn.ModuleList(EgnnSparseLayer(c) for _ in range(c.n_layers))
        self.lin = nn.Linear(c.input_dim, c.out_dim)

    def forward(self, feats, pos, src, dst, edge_attr):
        rel = pos[src] - pos[dst]
        ea = torch.cat([edge_attr, (rel * rel).sum(-1, keepdim=True)], -1)  # squared, no sqrt
        for layer in self.mpnn_layes:
            feats = layer(feats, ea, src, dst)
        return self.lin(feats)


def _empty(c: ProtssnEgnnConfig, device) -> ProtssnEgnn:
    with torch.device("meta"):
        model = ProtssnEgnn(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(c: ProtssnEgnnConfig, seed: int = 0, device="cuda") -> ProtssnEgnn:
    """Seeded random weights with the JAX ``init_egnn_params`` distribution
    (the draws differ): each (in, out) matrix N(0, 1 / in), zero biases."""
    model = _empty(c, device)
    dev = model.lin.weight.device
    gen = seeded_generator(seed, dev)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev)
                    * float(np.sqrt(1.0 / p.shape[1])))
    return model


def _strip(state_dict: Mapping) -> Dict:
    return {k.removeprefix("GNN_model."): v for k, v in state_dict.items()}


def config_from_state_dict(state_dict: Mapping, base: ProtssnEgnnConfig) -> ProtssnEgnnConfig:
    """n_layers, m_dim, input_dim and out_dim from the file's shapes; k, which
    the weights do not hold, from ``base``."""
    sd = _strip(state_dict)
    n_layers = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith("mpnn_layes."))
    return dataclasses.replace(
        base, n_layers=n_layers, m_dim=int(np.shape(sd["mpnn_layes.0.edge_mlp.3.weight"])[0]),
        input_dim=int(np.shape(sd["lin.weight"])[1]), out_dim=int(np.shape(sd["lin.weight"])[0]))


def base_config_for_file(path) -> ProtssnEgnnConfig:
    """The preset a published file's name (``protssn_k{k}_h{h}``) names, else
    ``ProtssnEgnnConfig()`` (k = 20), as the JAX ``convert`` falls back."""
    found = re.search(r"protssn_k(\d+)_h(\d+)", Path(path).stem)
    if found is None:
        return ProtssnEgnnConfig()
    k, h = int(found.group(1)), int(found.group(2))
    return PROTSSN_PRESETS.get(f"protssn_k{k}_h{h}") or ProtssnEgnnConfig(
        name=f"protssn_k{k}_h{h}", m_dim=h, k_neighbors=k)


def load_state_dict(state_dict: Mapping, c: ProtssnEgnnConfig, device="cuda") -> ProtssnEgnn:
    """The model from a published GNN state dict (``GNN_model.`` prefix
    optional)."""
    return copy_state_dict(_empty(c, device), _strip(state_dict), c.name)


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``init_egnn_params`` pytree (numpy leaves) in the published
    names."""
    sd = {}

    def lin(prefix, p):
        sd[f"{prefix}.weight"] = torch.from_numpy(np.array(np.asarray(p["w"]).T,
                                                           dtype=np.float32))
        sd[f"{prefix}.bias"] = torch.from_numpy(np.array(p["b"], dtype=np.float32))

    for i, layer in enumerate(params["layers"]):
        for ours, theirs in (("edge0", "edge_mlp.0"), ("edge1", "edge_mlp.3"),
                             ("node0", "node_mlp.0"), ("node1", "node_mlp.3")):
            lin(f"mpnn_layes.{i}.{theirs}", layer[ours])
    lin("lin", params["lin"])
    return sd


@torch.no_grad()
def egnn_log_probs(model: ProtssnEgnn, esm_rep, pos, src, dst, edge_attr) -> torch.Tensor:
    """log(softmax(logits) + 1e-9) (ref compute_fitness.py:64), (L, 20)
    float32 on the model's device; numpy inputs are moved there."""
    dev = model.lin.weight.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
    out = model(f32(esm_rep), f32(pos), idx(src), idx(dst), f32(edge_attr))
    return torch.log(F.softmax(out[:, :20], -1) + 1e-9)


def score_mutants_egnn(log_probs, sequence: str, mutants: Sequence[str],
                       offset_idx: int = 1) -> np.ndarray:
    """Sum over sub-mutants of logp[mt] - logp[wt] in the ``AA_PROTSSN``
    order (ref compute_fitness.py:31-50); ``wt`` tokens add 0."""
    aa_idx = {a: i for i, a in enumerate(AA_PROTSSN)}
    table = (log_probs.cpu().numpy() if torch.is_tensor(log_probs)
             else np.asarray(log_probs))
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        sep = ":" if ":" in m else ";"
        for tok in m.split(sep):
            if tok.lower() == "wt":
                continue
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if sequence[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            out[i] += table[pos, aa_idx[mt]] - table[pos, aa_idx[wt]]
    return out
