"""ESM-IF1 (the GVP-Transformer inverse-folding model) as PyTorch modules
(counterpart of proteingym_tpu/models/gvp_transformer.py; ref
esm/esm/inverse_folding/):

- the features: dihedrals, orientations, side-chain directions, the kNN
  graph with the missing-coordinate sort preference, RBF and positional
  edge features (features.py:77-352);
- the GVP graph embedding and the GVPConvLayer stack with vector gating
  (gvp_modules.py:113-475, gvp_encoder.py:18-56), messages averaged at
  each edge's ``dst`` by ``index_add_``;
- the transformer encoder over the summed geometric embeddings
  (gvp_transformer_encoder.py:23-184) and the autoregressive decoder with
  cross attention (transformer_decoder.py:24-228);
- scoring: the mean per-token log-likelihood of each sequence given the
  backbone (compute_fitness_esm_if1.py:19-39), one encoder pass per
  structure and batches of sequences through the decoder; the multichain
  path conditions on every chain of a complex (multichain_util.py).

Everything runs in float32, as in the JAX package. Self attention (query
and key lengths equal) goes through the port's ``mha`` with q pre-scaled:
on the card K1's float32 kernel, causal with the PAD key mask in the
decoder, with the padding mask in the encoder. Cross attention of unequal
lengths is plain PyTorch with a ``-inf`` fill and fairseq's NaN -> 0, as
the JAX function computes it; a decoder row as long as the encoder's
L + 2 sends it through ``mha`` too, by the JAX dispatch rule.

The kNN takes each residue's neighbours by a stable ascending sort, so
that tied distances go to the lower index as ``jax.lax.top_k`` sends them
(``torch.topk`` promises no order for ties on CUDA). The squared
distances are summed one coordinate at a time, so the card and the CPU
rank the same numbers.

Parameter names are fair-esm's (``encoder.*``, ``decoder.*``), so the
published ``{"model": state_dict}`` loads by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.ops.flash_attention import mha

# invariant_gvp alphabet (ref esm/esm/data.py:165-171)
PROTEIN_TOKS = list("LAGVSERTIDPKQNFYMHWCXBUZO") + [".", "-"]
IF1_TOKENS = (["<null_0>", "<pad>", "<eos>", "<unk>"] + PROTEIN_TOKS + ["<null_1>"]
              + ["<mask>", "<cath>", "<af2>"])
IF1_IDX = {t: i for i, t in enumerate(IF1_TOKENS)}
PAD_IDX, EOS_IDX, UNK_IDX = 1, 2, 3
MASK_IDX = IF1_IDX["<mask>"]
CATH_IDX = IF1_IDX["<cath>"]
VOCAB = len(IF1_TOKENS)  # 34


def tokenize(seq: str) -> np.ndarray:
    """[<cath>] + residues (prepend_bos=True, append_eos=False)."""
    return np.asarray([CATH_IDX] + [IF1_IDX.get(c, UNK_IDX) for c in seq], np.int64)


@dataclasses.dataclass(frozen=True)
class GVPTransformerConfig:
    name: str = "esm_if1"
    encoder_embed_dim: int = 512
    decoder_embed_dim: int = 512
    encoder_layers: int = 8
    decoder_layers: int = 8
    encoder_attention_heads: int = 8
    decoder_attention_heads: int = 8
    encoder_ffn_embed_dim: int = 2048
    decoder_ffn_embed_dim: int = 2048
    gvp_top_k_neighbors: int = 30
    gvp_node_hidden_dim_scalar: int = 1024
    gvp_node_hidden_dim_vector: int = 256
    gvp_edge_hidden_dim_scalar: int = 32
    gvp_edge_hidden_dim_vector: int = 1
    gvp_num_encoder_layers: int = 4


PRESETS = {
    # the published esm_if1_gvp4_t16_142M_UR50 layout
    "esm_if1": GVPTransformerConfig(),
    "esm_if1_tiny": GVPTransformerConfig(
        name="esm_if1_tiny", encoder_embed_dim=64, decoder_embed_dim=64, encoder_layers=2,
        decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
        encoder_ffn_embed_dim=128, decoder_ffn_embed_dim=128, gvp_top_k_neighbors=8,
        gvp_node_hidden_dim_scalar=32, gvp_node_hidden_dim_vector=8,
        gvp_edge_hidden_dim_scalar=16, gvp_num_encoder_layers=2),
}


# ---------------------------------------------------------------------------
# numerics shared with the reference (util.py:146-217, gvp_modules.py:79-111)

def _nan_to_num(x, val=0.0):
    return torch.where(torch.isfinite(x), x, torch.full_like(x, val))


def _sq3(x):
    """The sum of squares over a trailing axis of 3, one term at a time."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def _norm3(x, keepdim=False, eps=1e-8):
    n = torch.sqrt(_sq3(x) + eps)
    return n[..., None] if keepdim else n


def _normalize(x):
    return _nan_to_num(x / _norm3(x, keepdim=True))


def _norm_no_nan(x, dim=-1, keepdim=False, eps=1e-8, sqrt=True):
    out = x.square().sum(dim, keepdim=keepdim) + eps
    return torch.sqrt(out) if sqrt else out


def rbf(values, v_min, v_max, n_bins=16):
    centers = torch.linspace(v_min, v_max, n_bins, device=values.device)
    std = (v_max - v_min) / n_bins
    z = (values[..., None] - centers) / std
    return torch.exp(-z * z)


def rotate(v, R):
    """v @ R on the trailing 3-dims (ref util.py:146-159)."""
    return torch.einsum("...ci,...ij->...cj", v, R)


def get_rotation_frames(coords):
    v1 = coords[:, :, 2] - coords[:, :, 1]
    v2 = coords[:, :, 0] - coords[:, :, 1]
    e1 = _normalize(v1)
    u2 = v2 - e1 * (e1 * v2).sum(-1, keepdim=True)
    e2 = _normalize(u2)
    e3 = torch.linalg.cross(e1, e2, dim=-1)
    return torch.stack([e1, e2, e3], dim=-2)


# ---------------------------------------------------------------------------
# input features (features.py:77-352)

def _dihedrals(coords, eps=1e-7):
    """(B, L, 3, 3) -> (B, L, 6) cos/sin of phi/psi/omega."""
    b, n = coords.shape[:2]
    x = coords[:, :, :3].reshape(b, 3 * n, 3)
    u = _normalize(x[:, 1:] - x[:, :-1])
    u_2, u_1, u_0 = u[:, :-2], u[:, 1:-1], u[:, 2:]
    n_2 = _normalize(torch.linalg.cross(u_2, u_1, dim=-1))
    n_1 = _normalize(torch.linalg.cross(u_1, u_0, dim=-1))
    cos_d = torch.clamp((n_2 * n_1).sum(-1), -1 + eps, 1 - eps)
    d = torch.sign((u_2 * n_1).sum(-1)) * torch.arccos(cos_d)
    d = F.pad(d, (1, 2)).reshape(b, n, 3)
    return torch.cat([torch.cos(d), torch.sin(d)], -1)


def _orientations(x_ca):
    forward = F.pad(_normalize(x_ca[:, 1:] - x_ca[:, :-1]), (0, 0, 0, 1))
    backward = F.pad(_normalize(x_ca[:, :-1] - x_ca[:, 1:]), (0, 0, 1, 0))
    return torch.stack([forward, backward], dim=-2)


def _sidechains(coords):
    n, origin, c = coords[:, :, 0], coords[:, :, 1], coords[:, :, 2]
    c, n = _normalize(c - origin), _normalize(n - origin)
    bisector = _normalize(c + n)
    perp = _normalize(torch.linalg.cross(c, n, dim=-1))
    return -bisector * math.sqrt(1 / 3) - perp * math.sqrt(2 / 3)


def get_node_features(coords, coord_mask, with_coord_mask=True):
    scalars = _dihedrals(coords)
    if with_coord_mask:
        scalars = torch.cat([scalars, coord_mask.to(scalars.dtype)[..., None]], -1)
    vectors = torch.cat([_orientations(coords[:, :, 1]), _sidechains(coords)[:, :, None]], -2)
    return scalars, vectors


def knn(x_ca, coord_mask, padding_mask, top_k):
    """The kNN graph with the reference's missing-coordinate sort preference
    (features.py:156-185): (D_neighbors, E_idx, coord-valid, residue-valid),
    neighbours in ascending ``D_adjust``, ties to the lower index."""
    cm2 = coord_mask[:, :, None] & coord_mask[:, None, :]
    rm = ~padding_mask
    rm2 = rm[:, :, None] & rm[:, None, :]
    d = cm2 * _norm3(x_ca[:, :, None] - x_ca[:, None, :])
    pos = torch.arange(x_ca.shape[1], device=x_ca.device)
    dseq = (pos[:, None] - pos[None, :]).abs().to(d.dtype)
    d_adjust = _nan_to_num(d) + (~cm2) * (1e8 + dseq * 1e6) + (~rm2) * 1e10
    k = min(top_k, x_ca.shape[1])
    d_nb, e_idx = torch.sort(d_adjust, dim=-1, stable=True)
    d_nb, e_idx = d_nb[..., :k], e_idx[..., :k]
    return d_nb, e_idx, d_nb < 5e7, d_nb < 5e9


def _edge_positional_embeddings(d, num_embeddings=16):
    frequency = torch.exp(torch.arange(0, num_embeddings, 2, dtype=torch.float32,
                                       device=d.device) * -(np.log(10000.0) / num_embeddings))
    angles = d[..., None] * frequency
    return torch.cat([torch.cos(angles), torch.sin(angles)], -1)


def get_edge_features(coords, coord_mask, padding_mask, top_k):
    """((edge_s, edge_v), (src, dst), edge_valid), dense (B, L*k, ...): the
    reference's -1 edges become a validity mask (features.py:300-352)."""
    x_ca = coords[:, :, 1]
    e_dist, e_idx, e_cm, e_rm = knn(x_ca, coord_mask, padding_mask, top_k)
    b, n, k = e_idx.shape
    src = torch.arange(n, device=coords.device)[None, :, None].expand(b, n, k).reshape(b, n * k)
    dst = e_idx.reshape(b, n * k)
    e_dist, e_cm, e_rm = (x.reshape(b, n * k) for x in (e_dist, e_cm, e_rm))

    pos_emb = _edge_positional_embeddings((src - dst).float())
    d_rbf = rbf(e_dist, 0.0, 20.0)
    gather = lambda x, idx: torch.gather(x, 1, idx[..., None].expand(-1, -1, 3))  # noqa: E731
    cm_src, cm_dst = torch.gather(coord_mask, 1, src), torch.gather(coord_mask, 1, dst)
    vectors = gather(x_ca, src) - gather(x_ca, dst)
    w = e_cm[..., None].to(vectors.dtype)
    mean = (vectors * w).sum(1, keepdim=True) / w.sum(1, keepdim=True)
    vectors = vectors * w + mean * (1.0 - w)

    edge_v = _nan_to_num(_normalize(vectors))[:, :, None, :]
    edge_s = _nan_to_num(torch.cat([d_rbf, pos_emb], -1))
    edge_s = torch.cat([edge_s, (~cm_src).to(edge_s.dtype)[..., None],
                        (~cm_dst).to(edge_s.dtype)[..., None]], -1)
    # remove_edges_without_coords: edges without coordinates and edges
    # touching padding are invalid (features.py:349-351)
    return (edge_s, edge_v), (src, dst), e_rm & e_cm


# ---------------------------------------------------------------------------
# GVP modules (gvp_modules.py:113-475)

class GVP(nn.Module):
    """Geometric vector perceptron with vector inputs and outputs: ``wh``,
    ``ws``, ``wv`` and, with ``vector_gate``, ``wg``; the activations
    (ReLU on scalars, sigmoid gates on vectors) on or off together."""

    def __init__(self, si, vi, so, vo, vector_gate, activations, device=None):
        super().__init__()
        h = max(vi, vo)
        self.wh = nn.Linear(vi, h, bias=False, device=device)
        self.ws = nn.Linear(h + si, so, device=device)
        self.wv = nn.Linear(h, vo, bias=False, device=device)
        self.wg = nn.Linear(so, vo, device=device) if vector_gate else None
        self.activations = activations

    def forward(self, s, v, eps=1e-8):
        vh = self.wh(v.transpose(-1, -2))                      # (..., 3, h)
        s = self.ws(torch.cat([s, _norm_no_nan(vh, dim=-2, eps=eps)], -1))
        if self.activations:
            s = torch.relu(s)
        out_v = self.wv(vh).transpose(-1, -2)                  # (..., vo, 3)
        if self.activations:
            gate = (self.wg(s)[..., None] if self.wg is not None
                    else _norm_no_nan(out_v, keepdim=True, eps=eps))
            out_v = out_v * torch.sigmoid(gate)
        return s, out_v


class TupleLayerNorm(nn.Module):
    """LayerNorm of the scalars (eps 1e-5) and the vector norm of the GVP
    paper (gvp_modules.py:236-265); ``eps`` shapes the vector norm."""

    def __init__(self, dim, eps, device=None):
        super().__init__()
        self.scalar_norm = nn.LayerNorm(dim, device=device)
        self.eps = eps

    def forward(self, s, v):
        s = self.scalar_norm(s)
        vn = _norm_no_nan(v, keepdim=True, sqrt=False, eps=self.eps)
        nonzero = (vn > 2 * self.eps).to(v.dtype)
        vn = (vn * nonzero).sum(-2, keepdim=True) / (self.eps + nonzero.sum(-2, keepdim=True))
        return s, nonzero * (v / torch.sqrt(vn + self.eps))


def _seg_mean(msgs, dst, valid, n):
    """The mean of the valid edges' messages at each ``dst`` node
    (torch_geometric's aggr="mean" over the surviving edges)."""
    w = valid.to(msgs.dtype)
    shaped = w.reshape(w.shape + (1,) * (msgs.dim() - 1))
    total = msgs.new_zeros((n,) + msgs.shape[1:]).index_add_(0, dst, msgs * shaped)
    count = w.new_zeros(n).index_add_(0, dst, w).clamp(min=1.0)
    return total / count.reshape(count.shape + (1,) * (msgs.dim() - 1))


class GVPConv(nn.Module):
    def __init__(self, ns, nv, es, ev, device=None):
        super().__init__()
        self.message_func = nn.ModuleList([
            GVP(2 * ns + es, 2 * nv + ev, ns, nv, True, True, device),
            GVP(ns, nv, ns, nv, True, True, device),
            GVP(ns, nv, ns, nv, False, False, device),
        ])


class GVPConvLayer(nn.Module):
    """Message GVPs -> mean at dst -> residual + norm -> GVP feed-forward
    -> residual + norm (gvp_modules.py:331-475), on one flattened graph."""

    def __init__(self, ns, nv, es, ev, device=None):
        super().__init__()
        self.conv = GVPConv(ns, nv, es, ev, device)
        self.norm = nn.ModuleList([TupleLayerNorm(ns, 1e-4, device) for _ in range(2)])
        self.ff_func = nn.ModuleList([GVP(ns, nv, 4 * ns, 2 * nv, True, True, device),
                                      GVP(4 * ns, 2 * nv, ns, nv, False, False, device)])

    def forward(self, s, v, edge_s, edge_v, src, dst, edge_valid):
        ms = torch.cat([s[src], edge_s, s[dst]], -1)
        mv = torch.cat([v[src], edge_v, v[dst]], -2)
        for gvp in self.conv.message_func:
            ms, mv = gvp(ms, mv)
        n = s.shape[0]
        s, v = self.norm[0](s + _seg_mean(ms, dst, edge_valid, n),
                            v + _seg_mean(mv, dst, edge_valid, n))
        fs, fv = s, v
        for gvp in self.ff_func:
            fs, fv = gvp(fs, fv)
        return self.norm[1](s + fs, v + fv)


class GVPGraphEmbedding(nn.Module):
    def __init__(self, c: GVPTransformerConfig, device=None):
        super().__init__()
        ns, nv = c.gvp_node_hidden_dim_scalar, c.gvp_node_hidden_dim_vector
        es, ev = c.gvp_edge_hidden_dim_scalar, c.gvp_edge_hidden_dim_vector
        self.embed_node = nn.ModuleList([GVP(7, 3, ns, nv, False, False, device),
                                         TupleLayerNorm(ns, 1e-4, device)])
        self.embed_edge = nn.ModuleList([GVP(34, 1, es, ev, False, False, device),
                                         TupleLayerNorm(es, 1e-4, device)])
        self.embed_confidence = nn.Linear(16, ns, device=device)


class GVPEncoder(nn.Module):
    """GVPEncoder (gvp_encoder.py:18-56) on the batch's graphs flattened
    into one, node indices offset by batch row."""

    def __init__(self, c: GVPTransformerConfig, device=None):
        super().__init__()
        self.config = c
        self.embed_graph = GVPGraphEmbedding(c, device)
        self.encoder_layers = nn.ModuleList(
            GVPConvLayer(c.gvp_node_hidden_dim_scalar, c.gvp_node_hidden_dim_vector,
                         c.gvp_edge_hidden_dim_scalar, c.gvp_edge_hidden_dim_vector, device)
            for _ in range(c.gvp_num_encoder_layers))

    def forward(self, coords, coord_mask, padding_mask, confidence):
        g = self.embed_graph
        node_s, node_v = get_node_features(coords, coord_mask, with_coord_mask=True)
        (edge_s, edge_v), (src, dst), edge_valid = get_edge_features(
            coords, coord_mask, padding_mask, self.config.gvp_top_k_neighbors)
        s, v = g.embed_node[1](*g.embed_node[0](node_s, node_v))
        es, ev = g.embed_edge[1](*g.embed_edge[0](edge_s, edge_v))
        s = s + g.embed_confidence(rbf(confidence, 0.0, 1.0))

        b, n = s.shape[:2]
        offset = (torch.arange(b, device=s.device) * n)[:, None]
        fsrc, fdst = (src + offset).reshape(-1), (dst + offset).reshape(-1)
        fs, fv = s.reshape(b * n, -1), v.reshape(b * n, v.shape[-2], 3)
        fes, fev = es.reshape(-1, es.shape[-1]), ev.reshape(-1, ev.shape[-2], 3)
        for layer in self.encoder_layers:
            fs, fv = layer(fs, fv, fes, fev, fsrc, fdst, edge_valid.reshape(-1))
        return fs.reshape(b, n, -1), fv.reshape(b, n, -1, 3)


# ---------------------------------------------------------------------------
# transformer pieces

class MultiheadAttention(nn.Module):
    """fairseq MultiheadAttention, q scaled by head_dim ** -0.5 after its
    bias. Equal query and key lengths go through ``mha`` (K1 on the card);
    others through plain products with a ``-inf`` fill and NaN -> 0."""

    def __init__(self, dim, kv_dim, heads, device=None):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim, device=device)
        self.k_proj = nn.Linear(kv_dim, dim, device=device)
        self.v_proj = nn.Linear(kv_dim, dim, device=device)
        self.out_proj = nn.Linear(dim, dim, device=device)

    def forward(self, x_q, x_kv, key_padding_mask=None, causal=False):
        """``key_padding_mask`` (B or 1, Tk) True = padded; ``x_kv`` may have
        batch 1 against ``x_q``'s B (the encoder output shared by every
        decoder row)."""
        b, tq, d = x_q.shape
        tk, hd = x_kv.shape[1], d // self.heads

        def heads(y):  # (B, T, D) -> (B, H, T, hd) view
            return y.view(y.shape[0], y.shape[1], self.heads, hd).transpose(1, 2)

        q = heads(self.q_proj(x_q) * hd ** -0.5)
        k, v = heads(self.k_proj(x_kv)), heads(self.v_proj(x_kv))
        if tq == tk:
            k, v = k.expand(b, -1, -1, -1), v.expand(b, -1, -1, -1)
            km = None if key_padding_mask is None else ~key_padding_mask.expand(b, tk)
            ctx = mha(q, k, v, key_mask=km, causal=causal, sm_scale=1.0)
        else:
            scores = q @ k.transpose(-1, -2)
            if causal:
                future = torch.ones(tq, tk, dtype=torch.bool, device=q.device).triu(1)
                scores = scores.masked_fill(future, float("-inf"))
            if key_padding_mask is not None:
                scores = scores.masked_fill(key_padding_mask[:, None, None, :], float("-inf"))
            probs = torch.softmax(scores, -1)
            ctx = torch.where(torch.isnan(probs), torch.zeros_like(probs), probs) @ v
        return self.out_proj(ctx.transpose(1, 2).reshape(b, tq, d))


def sinusoidal_positions(tokens, dim, padding_idx=PAD_IDX):
    """fairseq SinusoidalPositionalEmbedding (esm/modules.py:274-309)."""
    t = tokens.shape[1]
    mask = tokens != padding_idx
    positions = torch.where(mask, torch.arange(t, device=tokens.device)[None] + padding_idx + 1,
                            torch.full_like(tokens, padding_idx))
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=tokens.device) * -emb)
    ang = positions[..., None].float() * freqs
    out = torch.cat([torch.sin(ang), torch.cos(ang)], -1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out * mask[..., None]


class DihedralFeatures(nn.Module):
    """A linear embedding of the dihedrals and the ``Normalize`` module
    (features.py:188-206): unbiased variance, eps inside the square root
    and added to sigma."""

    def __init__(self, dim, device=None):
        super().__init__()
        self.node_embedding = nn.Linear(6, dim, device=device)
        self.norm_nodes = nn.Module()
        self.norm_nodes.gain = nn.Parameter(torch.ones(dim, device=device))
        self.norm_nodes.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, dihedrals):
        x = self.node_embedding(dihedrals)
        mu = x.mean(-1, keepdim=True)
        sigma = torch.sqrt(x.var(-1, keepdim=True, unbiased=True) + 1e-6)
        return self.norm_nodes.gain * (x - mu) / (sigma + 1e-6) + self.norm_nodes.bias


class EncoderLayer(nn.Module):
    def __init__(self, dim, heads, ffn, device=None):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(dim, device=device)
        self.self_attn = MultiheadAttention(dim, dim, heads, device)
        self.final_layer_norm = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, ffn, device=device)
        self.fc2 = nn.Linear(ffn, dim, device=device)

    def forward(self, x, padding_mask):
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, h, key_padding_mask=padding_mask)
        return x + self.fc2(torch.relu(self.fc1(self.final_layer_norm(x))))


class DecoderLayer(nn.Module):
    def __init__(self, dim, enc_dim, heads, ffn, device=None):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(dim, device=device)
        self.self_attn = MultiheadAttention(dim, dim, heads, device)
        self.encoder_attn_layer_norm = nn.LayerNorm(dim, device=device)
        self.encoder_attn = MultiheadAttention(dim, enc_dim, heads, device)
        self.final_layer_norm = nn.LayerNorm(dim, device=device)
        self.fc1 = nn.Linear(dim, ffn, device=device)
        self.fc2 = nn.Linear(ffn, dim, device=device)

    def forward(self, x, self_mask, enc_out, enc_padding_mask):
        h = self.self_attn_layer_norm(x)
        x = x + self.self_attn(h, h, key_padding_mask=self_mask, causal=True)
        h = self.encoder_attn_layer_norm(x)
        x = x + self.encoder_attn(h, enc_out, key_padding_mask=enc_padding_mask)
        return x + self.fc2(torch.relu(self.fc1(self.final_layer_norm(x))))


class GVPTransformerEncoder(nn.Module):
    """gvp_transformer_encoder.py:73-184."""

    def __init__(self, c: GVPTransformerConfig, device=None):
        super().__init__()
        self.config = c
        d = c.encoder_embed_dim
        ns, nv = c.gvp_node_hidden_dim_scalar, c.gvp_node_hidden_dim_vector
        self.embed_tokens = nn.Embedding(VOCAB, d, device=device)
        self.embed_gvp_input_features = nn.Linear(15, d, device=device)
        self.embed_confidence = nn.Linear(16, d, device=device)
        self.embed_dihedrals = DihedralFeatures(d, device)
        self.gvp_encoder = GVPEncoder(c, device)
        self.embed_gvp_output = nn.Linear(ns + 3 * nv, d, device=device)
        self.layers = nn.ModuleList(
            EncoderLayer(d, c.encoder_attention_heads, c.encoder_ffn_embed_dim, device)
            for _ in range(c.encoder_layers))
        self.layer_norm = nn.LayerNorm(d, device=device)

    def forward(self, coords, padding_mask, confidence):
        """coords (B, L, 3, 3) with inf/NaN for missing atoms, padding (B, L)
        bool, confidence (B, L) -> (B, L, D)."""
        coord_mask = torch.isfinite(coords).all(-1).all(-1)
        coords = _nan_to_num(coords)
        mask_tokens = torch.where(padding_mask, PAD_IDX, MASK_IDX)
        d = self.config.encoder_embed_dim
        x = self.embed_tokens(mask_tokens) * math.sqrt(d)
        x = x + self.embed_dihedrals(_dihedrals(coords))

        gvp_s, gvp_v = self.gvp_encoder(coords, coord_mask, padding_mask, confidence)
        rt = get_rotation_frames(coords).transpose(-2, -1)
        x = x + self.embed_gvp_output(
            torch.cat([gvp_s, rotate(gvp_v, rt).reshape(gvp_v.shape[:2] + (-1,))], -1))
        x = x + self.embed_confidence(rbf(confidence, 0.0, 1.0))
        in_s, in_v = get_node_features(coords, coord_mask, with_coord_mask=False)
        x = x + self.embed_gvp_input_features(
            torch.cat([in_s, rotate(in_v, rt).reshape(in_v.shape[:2] + (-1,))], -1))
        x = x + sinusoidal_positions(mask_tokens, d)
        x = x * (~padding_mask)[..., None].to(x.dtype)
        for layer in self.layers:
            x = layer(x, padding_mask)
        return self.layer_norm(x)


class TransformerDecoder(nn.Module):
    """transformer_decoder.py:92-228: (B, T) previous tokens -> (B, T, V)."""

    def __init__(self, c: GVPTransformerConfig, device=None):
        super().__init__()
        self.config = c
        d = c.decoder_embed_dim
        self.embed_tokens = nn.Embedding(VOCAB, d, device=device)
        self.layers = nn.ModuleList(
            DecoderLayer(d, c.encoder_embed_dim, c.decoder_attention_heads,
                         c.decoder_ffn_embed_dim, device) for _ in range(c.decoder_layers))
        self.layer_norm = nn.LayerNorm(d, device=device)
        self.output_projection = nn.Linear(d, VOCAB, bias=False, device=device)

    def forward(self, prev_tokens, enc_out, enc_padding_mask):
        d = self.config.decoder_embed_dim
        x = self.embed_tokens(prev_tokens) * math.sqrt(d) + sinusoidal_positions(prev_tokens, d)
        self_mask = prev_tokens == PAD_IDX
        for layer in self.layers:
            x = layer(x, self_mask, enc_out, enc_padding_mask)
        return self.output_projection(self.layer_norm(x))


class GVPTransformerModel(nn.Module):
    def __init__(self, config: GVPTransformerConfig, device=None):
        super().__init__()
        self.config = config
        self.encoder = GVPTransformerEncoder(config, device)
        self.decoder = TransformerDecoder(config, device)

    def forward(self, coords, padding_mask, confidence, prev_tokens):
        """The whole model -> (B, T, V) logits (the reference returns
        (B, V, T))."""
        enc = self.encoder(coords, padding_mask, confidence)
        return self.decoder(prev_tokens, enc, padding_mask)


# ---------------------------------------------------------------------------
# weights

def _empty_model(config: GVPTransformerConfig, device) -> GVPTransformerModel:
    with torch.device("meta"):
        model = GVPTransformerModel(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: GVPTransformerConfig, seed: int = 0, device="cuda"):
    """Seeded random weights with the JAX ``init_params`` distributions (the
    draws differ): dense weights N(0, 1 / n_in), zero biases, token
    embeddings N(0, 1 / D), unit norm scales."""
    model = _empty_model(config, device)
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            n_out, n_in = module.weight.shape
            module.weight.copy_(torch.randn((n_out, n_in), generator=gen, device=dev)
                                / math.sqrt(n_in))
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            d = module.weight.shape[1]
            module.weight.copy_(torch.randn(tuple(module.weight.shape), generator=gen,
                                            device=dev) / math.sqrt(d))
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    norm = model.encoder.embed_dihedrals.norm_nodes
    norm.gain.fill_(1.0)
    norm.bias.zero_()
    return model


def load_state_dict(state_dict: Mapping, config: GVPTransformerConfig, device="cuda"):
    """The model from fair-esm's GVPTransformerModel state dict (the
    ``model`` entry of ``esm_if1_gvp4_t16_142M_UR50.pt``); the
    ``*_float_tensor`` buffers are dropped, a missing key raises."""
    state = {k: v for k, v in state_dict.items() if not k.endswith("_float_tensor")}
    return copy_state_dict(_empty_model(config, device), state, config.name)


def params_from_jax(params, config: GVPTransformerConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as a fair-esm-named state dict
    (JAX dense kernels are (in, out), torch Linear weights (out, in))."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def lin(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def ln(prefix, p):
        put(f"{prefix}.weight", p["g"])
        put(f"{prefix}.bias", p["b"])

    def gvp(prefix, p):
        for name, q in p.items():
            lin(f"{prefix}.{name}", q)

    def attn(prefix, p):
        for ours, theirs in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("o", "out_proj")):
            lin(f"{prefix}.{theirs}", p[ours])

    put("encoder.embed_tokens.weight", params["enc_embed_tokens"])
    put("decoder.embed_tokens.weight", params["dec_embed_tokens"])
    lin("encoder.embed_gvp_input_features", params["embed_gvp_input_features"])
    lin("encoder.embed_confidence", params["embed_confidence"])
    lin("encoder.embed_dihedrals.node_embedding", params["embed_dihedrals"]["lin"])
    put("encoder.embed_dihedrals.norm_nodes.gain", params["embed_dihedrals"]["norm"]["g"])
    put("encoder.embed_dihedrals.norm_nodes.bias", params["embed_dihedrals"]["norm"]["b"])
    lin("encoder.embed_gvp_output", params["embed_gvp_output"])
    ge, g = "encoder.gvp_encoder.embed_graph", params["graph"]
    for part in ("embed_node", "embed_edge"):
        gvp(f"{ge}.{part}.0", g[part]["gvp"])
        ln(f"{ge}.{part}.1.scalar_norm", g[part]["norm"])
    lin(f"{ge}.embed_confidence", g["embed_confidence"])
    for i, layer in enumerate(params["gvp_layers"]):
        b = f"encoder.gvp_encoder.encoder_layers.{i}"
        for j, p in enumerate(layer["msg"]):
            gvp(f"{b}.conv.message_func.{j}", p)
        ln(f"{b}.norm.0.scalar_norm", layer["norm0"])
        ln(f"{b}.norm.1.scalar_norm", layer["norm1"])
        for j, p in enumerate(layer["ff"]):
            gvp(f"{b}.ff_func.{j}", p)
    for i, layer in enumerate(params["enc_layers"]):
        b = f"encoder.layers.{i}"
        ln(f"{b}.self_attn_layer_norm", layer["attn_ln"])
        attn(f"{b}.self_attn", layer["attn"])
        ln(f"{b}.final_layer_norm", layer["final_ln"])
        lin(f"{b}.fc1", layer["fc1"])
        lin(f"{b}.fc2", layer["fc2"])
    ln("encoder.layer_norm", params["enc_norm"])
    for i, layer in enumerate(params["dec_layers"]):
        b = f"decoder.layers.{i}"
        ln(f"{b}.self_attn_layer_norm", layer["self_ln"])
        attn(f"{b}.self_attn", layer["self"])
        ln(f"{b}.encoder_attn_layer_norm", layer["cross_ln"])
        attn(f"{b}.encoder_attn", layer["cross"])
        ln(f"{b}.final_layer_norm", layer["final_ln"])
        lin(f"{b}.fc1", layer["fc1"])
        lin(f"{b}.fc2", layer["fc2"])
    ln("decoder.layer_norm", params["dec_norm"])
    lin("decoder.output_projection", params["out_proj"])
    return sd


# ---------------------------------------------------------------------------
# scoring (CoordBatchConverter semantics, util.py:220-267)

def prepare_structure(coords: np.ndarray, confidence: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(L, 3, 3) -> inf-flanked coords (L+2, 3, 3), confidence, padding, with
    CoordBatchConverter's semantics (util.py:249-266): the flanks carry
    inf coordinates and confidence 0 and are not padding; NaN residues
    (the multichain spacers) are padding."""
    n = len(coords)
    out = np.full((n + 2, 3, 3), np.inf, np.float32)
    out[1:-1] = coords
    conf = np.full(n + 2, -1.0, np.float32)
    conf[1:-1] = 1.0 if confidence is None else confidence
    padding = np.isnan(out[:, 0, 0])
    coord_mask = np.isfinite(out.sum((-1, -2)))
    return out, (conf * coord_mask - padding).astype(np.float32), padding


@torch.no_grad()
def encode_structure(model: GVPTransformerModel, coords: np.ndarray,
                     confidence: Optional[np.ndarray] = None):
    """One encoder pass over an (L, 3 or 4, 3) backbone: (encoder output
    (1, L+2, D), padding mask (1, L+2)) on the model's device."""
    dev = next(model.parameters()).device
    coords = np.asarray(coords, np.float32)[:, :3]  # N, CA, C
    pc, conf, padding = prepare_structure(coords, confidence)
    as_t = lambda x: torch.as_tensor(x, device=dev)[None]  # noqa: E731
    pad = as_t(padding)
    return model.encoder(as_t(pc), pad, as_t(conf)), pad


@torch.no_grad()
def decode_loglik(model: GVPTransformerModel, enc, enc_pad, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) token rows ([<cath>] + residues, PAD-filled) -> each row's mean
    log-likelihood of its residues given the encoder output."""
    prev, tgt = tokens[:, :-1], tokens[:, 1:]
    logp = torch.log_softmax(model.decoder(prev, enc, enc_pad), -1)
    ll = logp.gather(-1, tgt[..., None])[..., 0]
    mask = (tgt != PAD_IDX).to(ll.dtype)
    return (ll * mask).sum(-1) / mask.sum(-1)


def score_sequences(model: GVPTransformerModel, coords: np.ndarray, sequences: Sequence[str],
                    batch_size: int = 32, confidence: Optional[np.ndarray] = None) -> np.ndarray:
    """Mean per-token AR log-likelihood of each sequence given the backbone,
    the reference's ``ll_fullseq`` (compute_fitness_esm_if1.py:33-39). One
    encoder pass per structure; rows of ``batch_size`` through the decoder,
    every row PAD-filled to the longest sequence's length (so that every
    batch dispatches its cross attention as the JAX scorer's does). The
    last batch runs with the rows it has."""
    dev = next(model.parameters()).device
    enc, enc_pad = encode_structure(model, coords, confidence)
    rows = [tokenize(s) for s in sequences]
    t = max(len(r) for r in rows)
    out = np.zeros(len(rows))
    for s0 in range(0, len(rows), batch_size):
        blk = rows[s0:s0 + batch_size]
        tok = np.full((len(blk), t), PAD_IDX, np.int64)
        for i, r in enumerate(blk):
            tok[i, :len(r)] = r
        ll = decode_loglik(model, enc, enc_pad, torch.as_tensor(tok, device=dev))
        out[s0:s0 + len(blk)] = ll.double().cpu().numpy()
    return out


def concatenate_complex_coords(coords: Dict[str, np.ndarray], target_chain_id: str,
                               padding_length: int = 10) -> np.ndarray:
    """The target chain first, then every other chain after
    ``padding_length`` all-NaN residues (multichain_util.py:54-78); the
    spacers become encoder padding."""
    pad = np.full((padding_length, 3, 3), np.nan, np.float32)
    parts = [np.asarray(coords[target_chain_id], np.float32)[:, :3]]
    for chain_id, chain in coords.items():
        if chain_id != target_chain_id:
            parts += [pad, np.asarray(chain, np.float32)[:, :3]]
    return np.concatenate(parts, axis=0)


def score_sequences_in_complex(model: GVPTransformerModel, coords: Dict[str, np.ndarray],
                               target_chain_id: str, sequences: Sequence[str],
                               batch_size: int = 32, padding_length: int = 10) -> np.ndarray:
    """``ll_fullseq`` of target-chain sequences conditioned on the whole
    complex (multichain_util.py:105-135): the encoder sees every chain, the
    decoder teacher-forces the target chain."""
    return score_sequences(model, concatenate_complex_coords(coords, target_chain_id,
                                                             padding_length),
                           sequences, batch_size=batch_size)
