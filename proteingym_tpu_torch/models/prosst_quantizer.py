"""ProSST's structure-token quantizer: the residue graph, each residue's
local subgraph, the GVP encoder and the k-means assignment (counterpart of
proteingym_tpu/models/prosst_quantizer.py; ref
proteingym/baselines/prosst/prosst/structure/quantizer.py:43-360,
encoder/gvp.py:29-81, encoder/layer.py).

1. ``graph_features`` (host, numpy): edges where the CA-CA distance is
   under 10 A, node vectors (forward and backward CA directions, the
   side-chain bisector), edge scalars (16 RBF of the distance, 16
   sinusoids of the sequence offset) and unit edge vectors.
2. ``subgraph_indices`` / ``build_subgraph`` (host, numpy): an anchor's
   50 nearest residues by numpy's default ``argsort``, those under 10 A,
   cut to the first 40 when more than 30 remain, in index order; the
   subgraph's edges and their rows of the parent's edge features.
3. ``AutoGraphEncoder`` (card): the vendored GVPs without vector gating,
   the tuple LayerNorm, 6 message-passing layers that average their
   messages at ``dst`` (``index_add_`` and counts), a scalar head.
4. ``predict_tokens``: every anchor's subgraph in one disjoint-union
   graph, one encoder forward, a mean per anchor, L2 normalisation, the
   nearest of K centroids.

Parameters carry the vendored ``AE.pt`` names (``W_v.0.scalar_norm``,
``W_v.1.wh``, ``layers.N.conv.message_func.M.ws``, ...), so the
published file loads natively; the centroids are a (K, 256) matrix saved
as ``.npy``.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.state_dict import Named, copy_state_dict

# ---------------------------------------------------------------------------
# The residue graph (host)
# ---------------------------------------------------------------------------


MAX_DISTANCE = 10.0  # A, between CAs: the graph's edges and a subgraph's reach

def _unit(x):
    """x / ||x||, a zero vector mapped to zeros (torch's _normalize)."""
    n = np.linalg.norm(x, axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = x / n
    return np.nan_to_num(out)


def _rbf(d: np.ndarray, d_min=0.0, d_max=20.0, d_count=16) -> np.ndarray:
    mu = np.linspace(d_min, d_max, d_count)
    sigma = (d_max - d_min) / d_count
    return np.exp(-(((d[..., None] - mu) / sigma) ** 2))


def _positional_embeddings(offsets: np.ndarray, num=16) -> np.ndarray:
    freq = np.exp(np.arange(0, num, 2, dtype=np.float32) * -(np.log(10000.0) / num))
    angles = offsets[:, None] * freq
    return np.concatenate([np.cos(angles), np.sin(angles)], -1)


@dataclasses.dataclass
class ProsstGraph:
    node_s: np.ndarray  # (L, 20) zeros
    node_v: np.ndarray  # (L, 3, 3)
    edge_index: np.ndarray  # (2, E) [src, dst]
    edge_s: np.ndarray  # (E, 32)
    edge_v: np.ndarray  # (E, 1, 3)
    distances: np.ndarray  # (L, L) CA distances


def graph_features(coords: np.ndarray) -> ProsstGraph:
    """(L, 4, 3) N/CA/C/O backbone -> the residue graph, an edge between
    every two residues whose CAs lie within MAX_DISTANCE (ref
    quantizer.py:92-168)."""
    coords = np.asarray(coords, np.float64)
    ca = coords[:, 1]
    L = ca.shape[0]
    d = np.linalg.norm(ca[:, None] - ca[None, :], axis=-1)
    src, dst = np.where(d < MAX_DISTANCE)
    keep = src != dst
    src, dst = src[keep], dst[keep]

    fwd, bwd = np.zeros((L, 3)), np.zeros((L, 3))
    fwd[:-1] = _unit(ca[1:] - ca[:-1])
    bwd[1:] = _unit(ca[:-1] - ca[1:])
    n_at, origin, c_at = coords[:, 0], coords[:, 1], coords[:, 2]
    c_u, n_u = _unit(c_at - origin), _unit(n_at - origin)
    bisector = _unit(c_u + n_u)
    perp = _unit(np.cross(c_u, n_u))
    side = -bisector * math.sqrt(1 / 3) - perp * math.sqrt(2 / 3)
    node_v = np.stack([fwd, bwd, side], axis=1)

    pos_emb = _positional_embeddings((src - dst).astype(np.float32))
    e_vec = ca[src] - ca[dst]
    edge_s = np.concatenate([_rbf(np.linalg.norm(e_vec, axis=-1)), pos_emb], -1)
    return ProsstGraph(
        node_s=np.zeros((L, 20), np.float32),
        node_v=np.nan_to_num(node_v).astype(np.float32),
        edge_index=np.stack([src, dst]).astype(np.int64),
        edge_s=np.nan_to_num(edge_s).astype(np.float32),
        edge_v=np.nan_to_num(_unit(e_vec)[:, None, :]).astype(np.float32),
        distances=d,
    )


def subgraph_indices(distances: np.ndarray, anchor: int) -> np.ndarray:
    """The anchor's subgraph nodes (ref quantizer.py:183-198): the 50
    nearest by numpy's default argsort, those under MAX_DISTANCE, the
    first 40 of them when more than 30 remain, index-sorted."""
    order = np.argsort(distances[anchor])[:50]
    nearest = order[distances[anchor][order] < MAX_DISTANCE]
    if len(nearest) > 30:
        nearest = nearest[:40]
    return np.sort(nearest)


def _edge_rows(graph: ProsstGraph) -> np.ndarray:
    """(L, L) -> the parent edge's row, -1 where there is no edge."""
    L = graph.distances.shape[0]
    rows = np.full((L, L), -1, np.int64)
    rows[graph.edge_index[0], graph.edge_index[1]] = np.arange(graph.edge_index.shape[1])
    return rows


def build_subgraph(graph: ProsstGraph, anchor: int, edge_rows: Optional[np.ndarray] = None):
    """The anchor's subgraph: its nodes, its edges re-indexed to them, and
    each edge's row of the parent's edge features (ref
    quantizer.py:195-219). ``edge_rows`` (``_edge_rows(graph)``) may be
    passed in to serve many anchors."""
    nodes = subgraph_indices(graph.distances, anchor)
    sub_d = graph.distances[np.ix_(nodes, nodes)]
    s_src, s_dst = np.where(sub_d < MAX_DISTANCE)
    keep = s_src != s_dst
    s_src, s_dst = s_src[keep], s_dst[keep]
    rows = _edge_rows(graph) if edge_rows is None else edge_rows
    return {"nodes": nodes, "edge_index": np.stack([s_src, s_dst]).astype(np.int64),
            "edge_feat_rows": rows[nodes[s_src], nodes[s_dst]]}


# ---------------------------------------------------------------------------
# AutoGraphEncoder (card)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoGraphEncoderConfig:
    """The published quantizer's dims (ref quantizer.py:523-531)."""

    node_in: Tuple[int, int] = (20, 3)
    node_h: Tuple[int, int] = (256, 32)
    edge_in: Tuple[int, int] = (32, 1)
    edge_h: Tuple[int, int] = (64, 2)
    num_layers: int = 6


class TupleLayerNorm(nn.Module):
    """The vendored tuple LayerNorm (layer.py:189-211): the affine scalar LN
    (``scalar_norm``), vectors divided by their RMS norm over channels."""

    def __init__(self, ns: int):
        super().__init__()
        self.scalar_norm = nn.LayerNorm(ns)

    def forward(self, s, v):
        s = self.scalar_norm(s)
        vn = (v * v).sum(-1, keepdim=True).clamp(min=1e-8)
        return s, v / vn.mean(-2, keepdim=True).sqrt()


class GVP(nn.Module):
    """The vendored GVP without vector gating (layer.py:99-143): ``wh``
    mixes the vector channels, ``ws`` maps the scalars and the mixed
    vectors' norms, ``wv`` (absent for scalar-only outputs) the output
    vectors; ``scalar_act`` is ReLU or none, with ``vector_act`` the
    vectors scale by sigmoid(||v||)."""

    def __init__(self, si: int, vi: int, so: int, vo: int, scalar_act: bool, vector_act: bool):
        super().__init__()
        h = max(vi, vo)
        self.wh = nn.Linear(vi, h, bias=False)
        self.ws = nn.Linear(si + h, so)
        if vo:
            self.wv = nn.Linear(h, vo, bias=False)
        self.scalar_act, self.vector_act = scalar_act, vector_act

    def forward(self, s, v):
        vh = self.wh(v.transpose(-1, -2))  # (N, 3, h)
        vn = (vh * vh).sum(-2).clamp(min=1e-8).sqrt()
        s = self.ws(torch.cat([s, vn], -1))
        out_v = None
        if hasattr(self, "wv"):
            out_v = self.wv(vh).transpose(-1, -2)  # (N, vo, 3)
            if self.vector_act:
                nrm = (out_v * out_v).sum(-1, keepdim=True).clamp(min=1e-8).sqrt()
                out_v = out_v * torch.sigmoid(nrm)
        if self.scalar_act:
            s = torch.relu(s)
        return s, out_v


class ConvLayer(nn.Module):
    """GVPConvLayer, aggregation by mean, eval mode (layer.py:213-373):
    messages over (src, edge, dst) through 3 GVPs, averaged at ``dst``, a
    residual and the first tuple LN, a 2-GVP feed-forward at hidden
    (4 ns, 2 nv), a residual and the second tuple LN."""

    def __init__(self, ns: int, nv: int, es: int, ev: int):
        super().__init__()
        msg = [GVP(2 * ns + es, 2 * nv + ev, ns, nv, True, True),
               GVP(ns, nv, ns, nv, True, True), GVP(ns, nv, ns, nv, False, False)]
        self.conv = Named(message_func=nn.ModuleList(msg))
        self.ff_func = nn.ModuleList([GVP(ns, nv, 4 * ns, 2 * nv, True, True),
                                      GVP(4 * ns, 2 * nv, ns, nv, False, False)])
        self.norm = nn.ModuleList([TupleLayerNorm(ns), TupleLayerNorm(ns)])

    def forward(self, s, v, edge_s, edge_v, src, dst):
        ms = torch.cat([s[src], edge_s, s[dst]], -1)
        mv = torch.cat([v[src], edge_v, v[dst]], -2)
        for gvp in self.conv.message_func:
            ms, mv = gvp(ms, mv)
        n = s.shape[0]
        den = torch.zeros(n, dtype=s.dtype, device=s.device).index_add_(
            0, dst, torch.ones_like(dst, dtype=s.dtype)).clamp(min=1.0)
        agg_s = torch.zeros(n, ms.shape[-1], dtype=s.dtype, device=s.device).index_add_(
            0, dst, ms) / den[:, None]
        agg_v = torch.zeros(n, *mv.shape[1:], dtype=s.dtype, device=s.device).index_add_(
            0, dst, mv) / den[:, None, None]
        s, v = self.norm[0](s + agg_s, v + agg_v)
        fs, fv = s, v
        for gvp in self.ff_func:
            fs, fv = gvp(fs, fv)
        return self.norm[1](s + fs, v + fv)


class AutoGraphEncoder(nn.Module):
    """AutoGraphEncoder.get_embedding (encoder/gvp.py:29-81): (num_nodes,
    ns) scalar node embeddings."""

    def __init__(self, c: AutoGraphEncoderConfig):
        super().__init__()
        self.config = c
        (nsi, nvi), (ns, nv) = c.node_in, c.node_h
        (esi, evi), (es, ev) = c.edge_in, c.edge_h
        self.W_v = nn.ModuleList([TupleLayerNorm(nsi), GVP(nsi, nvi, ns, nv, False, False)])
        self.W_e = nn.ModuleList([TupleLayerNorm(esi), GVP(esi, evi, es, ev, False, False)])
        self.layers = nn.ModuleList(ConvLayer(ns, nv, es, ev) for _ in range(c.num_layers))
        # W_out = GVP(node_h, (ns, 0)) with the default activations: scalar ReLU
        self.W_out = nn.ModuleList([TupleLayerNorm(ns), GVP(ns, nv, ns, 0, True, False)])

    def forward(self, node_s, node_v, edge_s, edge_v, src, dst):
        s, v = self.W_v[1](*self.W_v[0](node_s, node_v))
        es, ev = self.W_e[1](*self.W_e[0](edge_s, edge_v))
        for layer in self.layers:
            s, v = layer(s, v, es, ev, src, dst)
        return self.W_out[1](*self.W_out[0](s, v))[0]


def _empty(c: AutoGraphEncoderConfig, device) -> AutoGraphEncoder:
    with torch.device("meta"):
        model = AutoGraphEncoder(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(c: AutoGraphEncoderConfig = AutoGraphEncoderConfig(), seed: int = 0,
                device="cuda") -> AutoGraphEncoder:
    """Seeded random weights with the JAX ``init_params`` distribution (the
    draws differ): every matrix N(0, 1 / n_in), zero biases, unit LN
    scales."""
    model = _empty(c, device)
    dev = model.W_v[0].scalar_norm.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if p.dim() == 2:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev) / math.sqrt(p.shape[1]))
        elif name.endswith("scalar_norm.weight"):
            p.fill_(1.0)
        else:
            p.zero_()
    return model


def config_from_state_dict(sd: Mapping) -> AutoGraphEncoderConfig:
    """The encoder's dims read from a vendored state dict ((out, in) weights)."""
    shape = lambda k: tuple(np.shape(sd[k]))  # noqa: E731
    return AutoGraphEncoderConfig(
        node_in=(shape("W_v.0.scalar_norm.weight")[0], shape("W_v.1.wh.weight")[1]),
        node_h=(shape("W_v.1.ws.weight")[0], shape("W_v.1.wv.weight")[0]),
        edge_in=(shape("W_e.0.scalar_norm.weight")[0], shape("W_e.1.wh.weight")[1]),
        edge_h=(shape("W_e.1.ws.weight")[0], shape("W_e.1.wv.weight")[0]),
        num_layers=1 + max(int(k.split(".")[1]) for k in sd if k.startswith("layers.")))


@torch.no_grad()
def load_state_dict(sd: Mapping, c: Optional[AutoGraphEncoderConfig] = None,
                    device="cuda") -> AutoGraphEncoder:
    """The encoder from a vendored state dict, its dims read from it
    unless ``c`` is given; a parameter it lacks raises."""
    c = config_from_state_dict(sd) if c is None else c
    return copy_state_dict(_empty(c, device), sd, "the ProSST quantizer")


def params_from_jax(params, c: AutoGraphEncoderConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) in the vendored names."""
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    sd: Dict[str, torch.Tensor] = {}

    def ln(prefix, p):
        sd[f"{prefix}.scalar_norm.weight"], sd[f"{prefix}.scalar_norm.bias"] = a(p["g"]), a(p["b"])

    def gvp(prefix, p):
        sd[f"{prefix}.wh.weight"] = a(np.asarray(p["wh"]["w"]).T)
        sd[f"{prefix}.ws.weight"] = a(np.asarray(p["ws"]["w"]).T)
        sd[f"{prefix}.ws.bias"] = a(p["ws"]["b"])
        if "wv" in p:
            sd[f"{prefix}.wv.weight"] = a(np.asarray(p["wv"]["w"]).T)

    ln("W_v.0", params["wv_ln"])
    gvp("W_v.1", params["wv"])
    ln("W_e.0", params["we_ln"])
    gvp("W_e.1", params["we"])
    for i, layer in enumerate(params["layers"]):
        for j, p in enumerate(layer["msg"]):
            gvp(f"layers.{i}.conv.message_func.{j}", p)
        for j, p in enumerate(layer["ff"]):
            gvp(f"layers.{i}.ff_func.{j}", p)
        ln(f"layers.{i}.norm.0", layer["norm0"])
        ln(f"layers.{i}.norm.1", layer["norm1"])
    ln("W_out.0", params["out_ln"])
    gvp("W_out.1", params["out"])
    return sd


# ---------------------------------------------------------------------------
# Tokens (predict_sturcture)
# ---------------------------------------------------------------------------


def union_graph(graph: ProsstGraph, anchors: Sequence[int]):
    """Every anchor's subgraph in one disjoint-union graph (host numpy):
    node_s, node_v, edge_s, edge_v, src, dst, and each node's anchor."""
    rows = _edge_rows(graph)
    parts = {k: [] for k in ("node_s", "node_v", "edge_s", "edge_v", "src", "dst", "batch")}
    offset = 0
    for b, anchor in enumerate(anchors):
        sub = build_subgraph(graph, anchor, edge_rows=rows)
        nodes = sub["nodes"]
        parts["node_s"].append(graph.node_s[nodes])
        parts["node_v"].append(graph.node_v[nodes])
        parts["edge_s"].append(graph.edge_s[sub["edge_feat_rows"]])
        parts["edge_v"].append(graph.edge_v[sub["edge_feat_rows"]])
        parts["src"].append(sub["edge_index"][0] + offset)
        parts["dst"].append(sub["edge_index"][1] + offset)
        parts["batch"].append(np.full(len(nodes), b, np.int64))
        offset += len(nodes)
    return {k: np.concatenate(v) for k, v in parts.items()}


@torch.no_grad()
def anchor_embeddings(model: AutoGraphEncoder, graph: ProsstGraph,
                      anchors: Optional[Sequence[int]] = None) -> torch.Tensor:
    """(n_anchors, ns) L2-normalised mean node embeddings of each anchor's
    subgraph (default: every residue), from one encoder forward over their
    disjoint union on the model's device."""
    if anchors is None:
        anchors = range(graph.node_s.shape[0])
    anchors = list(anchors)
    dev = model.W_v[0].scalar_norm.weight.device
    u = {k: torch.as_tensor(v, device=dev) for k, v in union_graph(graph, anchors).items()}
    emb = model(u["node_s"], u["node_v"], u["edge_s"], u["edge_v"], u["src"], u["dst"])
    n = len(anchors)
    counts = torch.zeros(n, dtype=emb.dtype, device=dev).index_add_(
        0, u["batch"], torch.ones_like(u["batch"], dtype=emb.dtype))
    pooled = torch.zeros(n, emb.shape[-1], dtype=emb.dtype, device=dev).index_add_(
        0, u["batch"], emb) / counts.clamp(min=1.0)[:, None]
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def centroid_distances(emb: torch.Tensor, centroids) -> torch.Tensor:
    """(n, K) squared distances of the embeddings to the centroids, as
    |e|^2 - 2 e.c + |c|^2."""
    cents = torch.as_tensor(np.asarray(centroids, np.float32), device=emb.device)
    return (emb * emb).sum(-1, keepdim=True) - 2.0 * emb @ cents.T + (cents * cents).sum(-1)


def predict_tokens(model: AutoGraphEncoder, graph: ProsstGraph, centroids) -> np.ndarray:
    """One structure token per residue, each the anchor of its subgraph
    (ref quantizer.py:333-360): the nearest centroid of its normalised
    pooled embedding."""
    d2 = centroid_distances(anchor_embeddings(model, graph), centroids)
    return d2.argmin(-1).cpu().numpy()


def structure_tokens_from_coords(coords: np.ndarray, model: AutoGraphEncoder,
                                 centroids) -> np.ndarray:
    """(L, 4, 3) backbone -> (L,) structure tokens: graph, subgraphs, the
    encoder and the k-means assignment."""
    return predict_tokens(model, graph_features(coords), centroids)


def load_centroids(path) -> np.ndarray:
    """A (K, ns) centroid matrix from ``.npy``. A scikit-learn ``.joblib``
    k-means file raises: save its ``cluster_centers_`` with ``np.save``."""
    path = Path(path)
    if path.suffix == ".joblib":
        raise ValueError(f"{path}: a .joblib k-means model needs scikit-learn and joblib; "
                         "save its cluster_centers_ as .npy (np.save) and pass that")
    return np.load(path).astype(np.float32)
