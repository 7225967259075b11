"""S2F / S3F: frozen ESM2 features fused with a structure GVP-GNN, and (S3F)
a molecular-surface stream (counterpart of proteingym_tpu/models/s3f.py;
ref proteingym/baselines/S3F/s3f/gvp.py:24-241, gvp_layer.py:90-388,
task.py:10-92, script/evaluate.py:98-125).

Two implementations, as in the JAX package:

1. **The weight-compatible GVP-GNN** of the published ``s2f.pth`` /
   ``s3f.pth`` (``TD_RESIDUES`` down), as ``FusionGvp``: the structure
   model under ``structure_model.`` in the published names
   (``residue_embdding``, ``W_v``, ``W_e``, ``layers.{i}.conv.message_func``,
   ``norm``, ``ff_func``, ``W_out`` and their ``surf_`` twins,
   ``surf_in_linear``, ``surf_in_mlp``) and the task head ``linear``;
   ``load_state_dict`` finds the structure model under
   ``model.structure_model.``, ``structure_model.`` or no prefix. The
   drorlab GVP differs from ESM-IF1's: norms clamped at 1e-8, the vector
   gate read from the *pre*-activation scalars, the scalar ReLU after the
   gate, every message and feed-forward GVP (the last included) gated, and
   a vector layer norm that divides by the root mean square. Messages over
   the 10 A radius graph are averaged at ``dst`` (``index_add_``, the count
   clamped at 1). The surface stream reads the *raw* ESM features, flips
   the edge vector's sign, and adds its **global mean** to every residue
   (a reference quirk, kept). The graphs are built on the host in numpy
   with the JAX function's calls (numpy's default ``argsort``).
2. **The GearNet-class surrogate** (``S3fConfig``): typed-relation
   message passing over the sequence neighbours and the k-NN graph, an
   RSA proxy, a fusion MLP.

Scoring swaps in the ESM logits (remapped to ``TD_RESIDUES``) at every
residue whose pLDDT is under 70 (ref task.py:88-91). Everything runs in
float32; the scorer runs inside ``devices.no_tf32()``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.data.mutants import is_wt_row
from proteingym_tpu_torch.devices import resolve_device, seeded_generator
from proteingym_tpu_torch.models.state_dict import Named, copy_state_dict
from proteingym_tpu_torch.ops.gnn import knn_graph

AA20 = "ACDEFGHIKLMNPQRSTVWY"
NUM_RELATIONS = 5  # sequence -2, -1, +1, +2, spatial k-NN


# ---------------------------------------------------------------------------
# The GearNet-class surrogate
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class S3fConfig:
    plm_dim: int = 1280
    hidden_dim: int = 128
    num_layers: int = 3
    k_neighbors: int = 10
    use_surface: bool = True  # S3F; False -> S2F


class RelationalLayer(nn.Module):
    def __init__(self, c: S3fConfig):
        super().__init__()
        # one (in, out) projection per relation type (GearNet's relational conv)
        self.rel_w = nn.Parameter(torch.empty(NUM_RELATIONS, c.hidden_dim, c.hidden_dim))
        self.self_w = nn.Linear(c.hidden_dim, c.hidden_dim)


class S3fSurrogate(nn.Module):
    """The JAX ``init_params`` pytree as a module: ``node_in``, ``surface``,
    ``layers.{i}.rel_w`` / ``self_w``, ``fuse``, ``head``."""

    def __init__(self, c: S3fConfig):
        super().__init__()
        self.config = c
        self.node_in = nn.Linear(c.plm_dim, c.hidden_dim)
        self.surface = nn.Linear(1, c.hidden_dim)
        self.layers = nn.ModuleList(RelationalLayer(c) for _ in range(c.num_layers))
        self.fuse = nn.Linear(c.plm_dim + c.hidden_dim, c.hidden_dim)
        self.head = nn.Linear(c.hidden_dim, len(AA20))


def _empty_surrogate(c: S3fConfig, device) -> S3fSurrogate:
    with torch.device("meta"):
        model = S3fSurrogate(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_params(c: S3fConfig, seed: int = 0, device="cuda") -> S3fSurrogate:
    """Seeded random weights with the JAX ``init_params`` distribution (the
    draws differ): matrices N(0, 2 / fan_in), zero biases."""
    model = _empty_surrogate(c, device)
    dev = model.head.weight.device
    gen = seeded_generator(seed, dev)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev)
                    * float(np.sqrt(2.0 / p.shape[-1 if p.dim() == 2 else -2])))
    return model


def surrogate_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX ``init_params`` pytree (numpy leaves) in the module's names."""
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    sd = {}
    for name in ("node_in", "surface", "fuse", "head"):
        sd[f"{name}.weight"] = a(np.asarray(params[name]["w"]).T)
        sd[f"{name}.bias"] = a(params[name]["b"])
    for i, layer in enumerate(params["layers"]):
        sd[f"layers.{i}.rel_w"] = a(layer["rel_w"])
        sd[f"layers.{i}.self_w.weight"] = a(np.asarray(layer["self_w"]["w"]).T)
        sd[f"layers.{i}.self_w.bias"] = a(layer["self_w"]["b"])
    return sd


def surrogate_load_state_dict(state_dict, c: S3fConfig, device="cuda") -> S3fSurrogate:
    return copy_state_dict(_empty_surrogate(c, device), state_dict, "S3F surrogate")


def _relational_neighbors(L: int, ca: torch.Tensor, k: int):
    """(R, L, K) neighbour indices and (R, L, K) validity per relation."""
    idx = np.arange(L)
    rels, valid = [], []
    for off in (-2, -1, 1, 2):
        rels.append(np.tile(np.clip(idx + off, 0, L - 1)[:, None], (1, k)))
        v = np.zeros((L, k), bool)
        v[:, 0] = (idx + off >= 0) & (idx + off < L)
        valid.append(v)
    spatial = knn_graph(ca, k).cpu().numpy()
    spatial_valid = np.ones((L, k), bool)
    if spatial.shape[1] < k:  # tiny proteins: pad, but do not count twice
        spatial_valid[:, spatial.shape[1]:] = False
        spatial = np.concatenate([spatial, np.tile(spatial[:, :1], (1, k - spatial.shape[1]))], 1)
    rels.append(spatial)
    valid.append(spatial_valid)
    return (torch.as_tensor(np.stack(rels), device=ca.device),
            torch.as_tensor(np.stack(valid), device=ca.device))


def _ln(x, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


@torch.no_grad()
def logits(model: S3fSurrogate, plm_embeddings: torch.Tensor, ca_coords: torch.Tensor,
           rsa: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(L, plm_dim) + (L, 3) [+ (L,) RSA] -> (L, 20) log-probs."""
    c = model.config
    L = plm_embeddings.shape[0]
    nbrs, valid = _relational_neighbors(L, ca_coords, c.k_neighbors)
    h = model.node_in(plm_embeddings)
    if c.use_surface and rsa is not None:
        h = h + model.surface(rsa[:, None])
    for layer in model.layers:
        msgs = [torch.where(valid[r][..., None], h[nbrs[r]], 0.0).sum(1) @ layer.rel_w[r]
                for r in range(NUM_RELATIONS)]
        h = _ln(h + torch.relu(sum(msgs) + layer.self_w(h)))
    z = torch.relu(model.fuse(torch.cat([plm_embeddings, h], -1)))
    return torch.log_softmax(model.head(z), -1)


def score_mutants(model: S3fSurrogate, plm_embeddings, coords: np.ndarray, sequence: str,
                  mutants: Sequence[str], msa_sequences: Optional[Sequence[str]] = None,
                  msa_alpha: float = 0.3, offset_idx: int = 1) -> np.ndarray:
    """Log p(mt) - log p(wt) over the mutated positions; S3F-MSA blends the
    alignment prior into the table. WT rows score 0."""
    from proteingym_tpu_torch.models.rsalor import rsa_from_structure
    from proteingym_tpu_torch.models.structure_plms import alignment_count_logits

    dev = model.head.weight.device
    rsa = (torch.as_tensor(rsa_from_structure(coords), dtype=torch.float32, device=dev)
           if model.config.use_surface else None)
    table = logits(model, torch.as_tensor(plm_embeddings, dtype=torch.float32, device=dev),
                   torch.as_tensor(coords[:, 1], dtype=torch.float32, device=dev),
                   rsa).cpu().numpy()
    if msa_sequences:
        table = (1 - msa_alpha) * table + msa_alpha * alignment_count_logits(msa_sequences)
    return score_table(table, {a: i for i, a in enumerate(AA20)}, sequence, mutants, offset_idx)


def score_table(table, aa_idx, sequence: str, mutants: Sequence[str],
                offset_idx: int = 1) -> np.ndarray:
    """Each mutant's sum over its positions of table[pos, mt] - table[pos,
    wt], columns by ``aa_idx``; WT rows score 0, a wrong WT letter raises."""
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        if is_wt_row(m):
            continue
        for tok in m.split(":"):
            wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx, tok[-1]
            if sequence[pos] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            out[i] += table[pos, aa_idx[mt]] - table[pos, aa_idx[wt]]
    return out


# ---------------------------------------------------------------------------
# The weight-compatible S2F / S3F (published s2f.pth / s3f.pth)
# ---------------------------------------------------------------------------

# torchdrug's residue order (Protein.residue2id): the head's 20 outputs
TD_RESIDUES = "GASPVTCLINDQKEMHFRYW"


@dataclasses.dataclass(frozen=True)
class GvpGnnConfig:
    name: str = "s2f"
    node_in: int = 1280             # ESM2-650M features
    node_h_s: int = 256
    node_h_v: int = 16
    edge_in_s: int = 16             # RBF bins
    edge_h_s: int = 64
    edge_h_v: int = 1
    num_layers: int = 5
    radius: float = 10.0
    use_surface: bool = False       # True: the SurfGVP (S3F)
    surf_in_s: int = 42
    surf_edge_in_s: int = 16
    num_surf_res_neighbor: int = 3  # k: surface point <- residues
    num_surf_graph_neighbor: int = 16


S3F_PRESETS = {
    "s2f": GvpGnnConfig(name="s2f"),
    "s3f": GvpGnnConfig(name="s3f", use_surface=True),
    "s2f_tiny": GvpGnnConfig(name="s2f_tiny", node_in=32, node_h_s=24, node_h_v=4, edge_h_s=8,
                             num_layers=2),
    "s3f_tiny": GvpGnnConfig(name="s3f_tiny", node_in=32, node_h_s=24, node_h_v=4, edge_h_s=8,
                             num_layers=2, use_surface=True, surf_in_s=10),
}


def _dror_norm(x, dim=-1, keepdim=False, sqrt=True):
    out = (x * x).sum(dim, keepdim=keepdim).clamp(min=1e-8)
    return torch.sqrt(out) if sqrt else out


class DrorGvp(nn.Module):
    """The drorlab GVP (gvp_layer.py:90-153), activations (ReLU, None),
    vector gate on: ``wh`` (vi -> h) and ``wv`` (h -> vo) without bias,
    ``ws`` (h + si -> so), ``wsv`` (so -> vo); h = max(vi, vo). Without
    vector inputs only ``ws`` (si -> so), and the vectors out are zeros."""

    def __init__(self, si: int, vi: int, so: int, vo: int):
        super().__init__()
        self.vo = vo
        self.wh = self.wv = self.wsv = None
        if vi:
            h = max(vi, vo)
            self.wh = nn.Linear(vi, h, bias=False)
            self.ws = nn.Linear(h + si, so)
            if vo:
                self.wv = nn.Linear(h, vo, bias=False)
                self.wsv = nn.Linear(so, vo)
        else:
            self.ws = nn.Linear(si, so)

    def forward(self, s, v, scalar_act: bool):
        out_v = None
        if self.wh is not None:
            vh = self.wh(v.transpose(-1, -2))  # (..., 3, h)
            s = self.ws(torch.cat([s, _dror_norm(vh, dim=-2)], -1))
            if self.vo:
                # the gate from the pre-activation scalars
                out_v = self.wv(vh).transpose(-1, -2) * torch.sigmoid(self.wsv(s))[..., None]
        else:
            s = self.ws(s)
            if self.vo:
                out_v = s.new_zeros(s.shape[:-1] + (self.vo, 3))
        return (torch.relu(s) if scalar_act else s), out_v


class GvpLayerNorm(nn.Module):
    """GVPLayerNorm (gvp_layer.py:202-223): ``scalar_norm`` over the scalars,
    the vectors divided by the root mean square of their clamped squared
    norms."""

    def __init__(self, ns: int):
        super().__init__()
        self.scalar_norm = nn.LayerNorm(ns)

    def forward(self, s, v=None):
        s = self.scalar_norm(s)
        if v is None:
            return s, None
        vn = _dror_norm(v, dim=-1, keepdim=True, sqrt=False)
        return s, v / torch.sqrt(vn.mean(-2, keepdim=True))


class GvpConvLayer(nn.Module):
    """GVPConvLayer with mean aggregation (gvp_layer.py:226-388), eval mode:
    ``conv.message_func`` (3 GVPs), ``norm`` (2 layer norms), ``ff_func``
    (2 GVPs)."""

    def __init__(self, c: GvpGnnConfig):
        super().__init__()
        ns, nv, es, ev = c.node_h_s, c.node_h_v, c.edge_h_s, c.edge_h_v
        self.conv = Named(message_func=nn.ModuleList([
            DrorGvp(2 * ns + es, 2 * nv + ev, ns, nv), DrorGvp(ns, nv, ns, nv),
            DrorGvp(ns, nv, ns, nv)]))
        self.norm = nn.ModuleList([GvpLayerNorm(ns), GvpLayerNorm(ns)])
        self.ff_func = nn.ModuleList([DrorGvp(ns, nv, 4 * ns, 2 * nv),
                                      DrorGvp(4 * ns, 2 * nv, ns, nv)])

    def forward(self, s, v, edge_s, edge_v, src, dst):
        ms = torch.cat([s[src], edge_s, s[dst]], -1)
        mv = torch.cat([v[src], edge_v, v[dst]], -2)
        msg = self.conv.message_func
        for i, gvp in enumerate(msg):
            ms, mv = gvp(ms, mv, scalar_act=i < len(msg) - 1)
        n = s.shape[0]
        den = torch.zeros(n, dtype=ms.dtype, device=ms.device).index_add_(
            0, dst, torch.ones_like(dst, dtype=ms.dtype)).clamp(min=1.0)
        agg_s = torch.zeros_like(s).index_add_(0, dst, ms) / den[:, None]
        agg_v = torch.zeros_like(v).index_add_(0, dst, mv) / den[:, None, None]
        s, v = self.norm[0](s + agg_s, v + agg_v)
        fs, fv = s, v
        for i, gvp in enumerate(self.ff_func):
            fs, fv = gvp(fs, fv, scalar_act=i < len(self.ff_func) - 1)
        return self.norm[1](s + fs, v + fv)


def _rbf16(d, d_max=20.0, dim=16):
    mu = torch.linspace(0.0, d_max, dim, device=d.device)
    return torch.exp(-(((d[..., None] - mu) / (d_max / dim)) ** 2))


class GvpGnn(nn.Module):
    """The structure model (SurfGVP / GVPGNN, gvp.py:24-241) in the published
    names; the surface stream's modules carry ``surf_`` when
    ``use_surface``."""

    def __init__(self, c: GvpGnnConfig):
        super().__init__()
        self.config = c
        self.residue_embdding = nn.Linear(c.node_in, c.node_in, bias=False)
        self._add_stream("")
        if c.use_surface:
            self.surf_in_linear = nn.Linear(c.node_in + 1, c.node_in, bias=False)
            self.surf_in_mlp = nn.Sequential(
                nn.Linear(c.node_in + c.surf_in_s, 2 * c.node_in), nn.Identity(),
                nn.LayerNorm(2 * c.node_in), nn.ReLU(), nn.Linear(2 * c.node_in, c.node_in))
            self._add_stream("surf_")

    def _add_stream(self, pre: str):
        c = self.config
        ns, nv = c.node_h_s, c.node_h_v
        setattr(self, f"{pre}W_v", nn.ModuleList([GvpLayerNorm(c.node_in),
                                                   DrorGvp(c.node_in, 0, ns, nv)]))
        setattr(self, f"{pre}W_e", nn.ModuleList([GvpLayerNorm(c.edge_in_s),
                                                   DrorGvp(c.edge_in_s, 1, c.edge_h_s,
                                                           c.edge_h_v)]))
        setattr(self, f"{pre}layers", nn.ModuleList(GvpConvLayer(c)
                                                     for _ in range(c.num_layers)))
        setattr(self, f"{pre}W_out", nn.ModuleList([GvpLayerNorm(ns), DrorGvp(ns, nv, ns, 0)]))

    def stream(self, pre: str, h_in, pos, src, dst, flip_edge_vec: bool = False):
        """GVPGNN.forward minus the head (gvp.py:224-241) -> (N, ns). The
        surface stream takes the opposite edge-vector sign (gvp.py:110
        pos_in - pos_out against gvp.py:227 pos_out - pos_in)."""
        W_v, W_e, W_out = (getattr(self, f"{pre}{n}") for n in ("W_v", "W_e", "W_out"))
        s, v = W_v[1](W_v[0](h_in)[0], None, scalar_act=False)
        delta = pos[src] - pos[dst] if flip_edge_vec else pos[dst] - pos[src]
        es, ev = W_e[0](_rbf16(torch.linalg.norm(pos[dst] - pos[src], dim=-1),
                               dim=self.config.edge_in_s), delta[:, None, :])
        es, ev = W_e[1](es, ev, scalar_act=False)
        for layer in getattr(self, f"{pre}layers"):
            s, v = layer(s, v, es, ev, src, dst)
        s, v = W_out[0](s, v)
        return W_out[1](s, v, scalar_act=True)[0]

    def surface_feature(self, h_res, surface) -> torch.Tensor:
        """The SurfGVP surface branch (gvp.py:98-158) -> (1, ns): surface
        points inherit the raw features of their k nearest residues and run
        their own stream. SurfGVP.residue2surface returns nothing
        (gvp.py:96-100), so the read-back indexes with None: the global mean
        surface feature, added to every residue (a reference quirk, kept)."""
        dev = h_res.device
        t = lambda k, dt=torch.float32: torch.as_tensor(surface[k], dtype=dt, device=dev)  # noqa: E731
        surf2res, s_src, s_dst = (t(k, torch.long) for k in ("surf2res", "src", "dst"))
        inherited = torch.cat([h_res[surf2res], t("surf2res_dist")[..., None]], -1)
        hs = self.surf_in_mlp(torch.cat([self.surf_in_linear(inherited).mean(1), t("feature")],
                                        -1))
        out = self.stream("surf_", hs, t("position"), s_src, s_dst, flip_edge_vec=True)
        return out.mean(0, keepdim=True)

    def node_feature(self, esm_feats, pos, src, dst, surface=None):
        """(L, node_in) ESM features, (L, 3) CA, (E,) src / dst -> (L, ns)."""
        node_feat = self.stream("", self.residue_embdding(esm_feats), pos, src, dst)
        if self.config.use_surface and surface is not None:
            # the surface branch receives the raw features (gvp.py:124-141)
            node_feat = node_feat + self.surface_feature(esm_feats, surface)
        return node_feat


class FusionGvp(nn.Module):
    """The published task's parts that score: ``structure_model`` and the
    ResidueTypePrediction head ``linear`` (task.py:21)."""

    def __init__(self, c: GvpGnnConfig):
        super().__init__()
        self.config = c
        self.structure_model = GvpGnn(c)
        self.linear = nn.Linear(c.node_h_s, 20)

    def forward(self, esm_feats, pos, src, dst, surface=None):
        """-> (L, 20) logits in ``TD_RESIDUES`` order (task.py:74-88)."""
        return self.linear(self.structure_model.node_feature(esm_feats, pos, src, dst, surface))


def _empty(c: GvpGnnConfig, device) -> FusionGvp:
    with torch.device("meta"):
        model = FusionGvp(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(c: GvpGnnConfig, seed: int = 0, device="cuda") -> FusionGvp:
    """Seeded random weights with the JAX ``gvpgnn_init`` distribution (the
    draws differ): each (in, out) matrix N(0, 1 / in), zero biases, unit
    layer-norm scales."""
    model = _empty(c, device)
    dev = model.linear.weight.device
    gen = seeded_generator(seed, dev)
    for name, p in model.named_parameters():
        owner = model.get_submodule(name.rsplit(".", 1)[0])
        if isinstance(owner, nn.LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev)
                    * float(np.sqrt(1.0 / p.shape[1])))
    return model


def _base_prefix(state_dict: Mapping) -> str:
    """The structure model's prefix in a published file: ``model.structure_model.``,
    ``structure_model.`` or none, the candidates of the JAX
    ``convert_torch_state_dict_gvpgnn``. The JAX function probes
    ``W_v.1.wh.weight``, which a GVP without vector inputs does not have, so
    it reads only bare files; this probes ``W_v.1.ws.weight``."""
    for cand in ("model.structure_model.", "structure_model."):
        if f"{cand}W_v.1.ws.weight" in state_dict:
            return cand
    return ""


def state_shape(state_dict: Mapping):
    """(layers, node_in, node_h_s, surface stream) of a published file."""
    pre = _base_prefix(state_dict)
    layers = 1 + max(int(k[len(pre) + 7:].split(".")[0]) for k in state_dict
                     if k.startswith(f"{pre}layers."))
    return (layers, int(np.shape(state_dict[f"{pre}residue_embdding.weight"])[0]),
            int(np.shape(state_dict[f"{pre}W_v.1.ws.weight"])[0]),
            f"{pre}surf_in_linear.weight" in state_dict)


def config_shape(c: GvpGnnConfig):
    return c.num_layers, c.node_in, c.node_h_s, c.use_surface


def load_state_dict(state_dict: Mapping, c: GvpGnnConfig, device="cuda") -> FusionGvp:
    """The model from a published S2F / S3F file: the structure model (bare
    or under ``model.structure_model.`` / ``structure_model.``) and the head
    (``linear``, ``model.linear`` or ``task.linear``)."""
    pre = _base_prefix(state_dict)
    sd = {"structure_model." + k[len(pre):]: v for k, v in state_dict.items()
          if k.startswith(pre)}
    head = next((h for h in ("linear", "model.linear", "task.linear")
                 if f"{h}.weight" in state_dict), None)
    if head is None:
        raise KeyError("no task linear head found in checkpoint")
    sd["linear.weight"], sd["linear.bias"] = (state_dict[f"{head}.weight"],
                                              state_dict[f"{head}.bias"])
    return copy_state_dict(_empty(c, device), sd, c.name)


def radius_graph(pos: np.ndarray, radius: float) -> Tuple[np.ndarray, np.ndarray]:
    """Ordered pairs (i != j) closer than ``radius`` (torchdrug SpatialEdge,
    min_distance 0): src = node_in, dst = node_out, row-major."""
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    src, dst = np.nonzero((d < radius) & ~np.eye(len(pos), dtype=bool))
    return src.astype(np.int32), dst.astype(np.int32)


def build_surface_inputs(surf_pos: np.ndarray, surf_feat: np.ndarray, res_pos: np.ndarray,
                         c: GvpGnnConfig) -> Dict[str, np.ndarray]:
    """The surface graph's arrays (gvp.py:102-118), on the host: each point's
    k nearest residues with their distances (surface.py:43-60), and a k-NN
    point graph whose edges run neighbour -> centre (torch_cluster's
    knn_graph convention)."""
    d2 = ((surf_pos[:, None] - res_pos[None, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)
    surf2res = order[:, :c.num_surf_res_neighbor]
    dist = np.sqrt(np.take_along_axis(d2, surf2res, axis=1))
    S = len(surf_pos)
    dd = np.linalg.norm(surf_pos[:, None] - surf_pos[None, :], axis=-1)
    np.fill_diagonal(dd, np.inf)
    kk = min(c.num_surf_graph_neighbor, S - 1)
    nbr = np.argsort(dd, axis=1)[:, :kk]
    return {"position": surf_pos.astype(np.float32), "feature": surf_feat.astype(np.float32),
            "surf2res": surf2res.astype(np.int32), "surf2res_dist": dist.astype(np.float32),
            "src": nbr.reshape(-1).astype(np.int32),
            "dst": np.repeat(np.arange(S, dtype=np.int32), kk)}


@torch.no_grad()
def gvpgnn_node_logits(model: FusionGvp, esm_feats, pos, src, dst, surface=None) -> torch.Tensor:
    """(L, 20) float32 logits on the model's device in ``TD_RESIDUES`` order;
    numpy inputs are moved there."""
    dev = model.linear.weight.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    idx = lambda x: torch.as_tensor(x, dtype=torch.long, device=dev)  # noqa: E731
    return model(f32(esm_feats), f32(pos), idx(src), idx(dst), surface)


def score_mutants_gvpgnn(logits, esm_logits20: Optional[np.ndarray],
                         plddt: Optional[np.ndarray], sequence: str, mutants: Sequence[str],
                         plddt_threshold: float = 70.0, offset_idx: int = 1) -> np.ndarray:
    """evaluate.py:98-125 with task.py's pLDDT fallback: the rows whose
    B-factor is under ``plddt_threshold`` take the (remapped) ESM logits;
    float32 log-softmax, then log p(mt) - log p(wt) summed. WT rows score 0."""
    table = torch.as_tensor(np.asarray(logits.cpu() if torch.is_tensor(logits) else logits,
                                       np.float32))
    if plddt is not None and esm_logits20 is not None:
        low = torch.as_tensor(np.asarray(plddt) < plddt_threshold)
        table = torch.where(low[:, None], torch.as_tensor(esm_logits20, dtype=torch.float32),
                            table)
    logp = torch.log_softmax(table, -1).numpy()
    return score_table(logp, {a: i for i, a in enumerate(TD_RESIDUES)}, sequence, mutants,
                       offset_idx)


def params_from_jax(params, c: GvpGnnConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``gvpgnn_init`` pytree (numpy leaves) in ``FusionGvp``'s
    names."""
    sd = {}
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731

    def lin(name, p):
        sd[f"{name}.weight"] = a(np.asarray(p["w"]).T)
        if "b" in p:
            sd[f"{name}.bias"] = a(p["b"])

    def ln(name, p):
        sd[f"{name}.scalar_norm.weight"], sd[f"{name}.scalar_norm.bias"] = a(p["g"]), a(p["b"])

    def gvp(name, p):
        for key, q in p.items():
            lin(f"{name}.{key}", q)

    def stream(pre, st):
        ln(f"{pre}W_v.0", st["in_norm"])
        gvp(f"{pre}W_v.1", st["W_v"])
        ln(f"{pre}W_e.0", st["edge_norm"])
        gvp(f"{pre}W_e.1", st["W_e"])
        ln(f"{pre}W_out.0", st["out_norm"])
        gvp(f"{pre}W_out.1", st["W_out"])
        for i, layer in enumerate(st["layers"]):
            b = f"{pre}layers.{i}"
            for j, p in enumerate(layer["msg"]):
                gvp(f"{b}.conv.message_func.{j}", p)
            ln(f"{b}.norm.0", layer["norm0"])
            ln(f"{b}.norm.1", layer["norm1"])
            for j, p in enumerate(layer["ff"]):
                gvp(f"{b}.ff_func.{j}", p)

    lin("structure_model.residue_embdding", params["residue_embedding"])
    stream("structure_model.", params["stream"])
    lin("linear", params["head"])
    if c.use_surface:
        lin("structure_model.surf_in_linear", params["surf_in_linear"])
        mlp = params["surf_in_mlp"]
        lin("structure_model.surf_in_mlp.0", mlp["lin1"])
        sd["structure_model.surf_in_mlp.2.weight"] = a(mlp["ln"]["g"])
        sd["structure_model.surf_in_mlp.2.bias"] = a(mlp["ln"]["b"])
        lin("structure_model.surf_in_mlp.4", mlp["lin2"])
        stream("structure_model.surf_", params["surf_stream"])
    return sd
