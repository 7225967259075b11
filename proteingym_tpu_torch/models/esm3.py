"""ESM3 with its structure track, as PyTorch modules (counterpart of
proteingym_tpu/models/esm3.py; ref proteingym/baselines/evoscale/):

- the multi-track input encoder: sequence, structure tokens, plddt RBFs,
  ss8, sasa, and the optional function and residue-annotation bags
  (esm/models/esm3.py:69-155);
- the trunk: ESM-C's blocks (``models/esmc.py``) with residue scaling
  sqrt(n_layers / 36), biases off, and geometric attention in block 0
  (esm/layers/blocks.py:56-162, geom_attention.py:9-150);
- backbone frames by Gram-Schmidt with the "black hole" average frame for
  residues without coordinates (esm/utils/structure/affine3d.py:308-374);
- the structure VQ-VAE encoder: kNN neighbourhoods, relative-position
  embeddings, geometric-only blocks, the nearest code of the codebook
  (esm/models/vqvae.py:145-325, utils/misc.py:85-124);
- scoring: masked marginals with the structure track fixed, score =
  logp[mt] - logp[wt] (evoscale/compute_fitness.py:296-470).

Everything runs in float32, as in the JAX package; on the card the
products run in full float32 (the scorer runs inside
``devices.no_tf32()``) and the trunk's plain attention is the port's
``mha``: K1's float32 kernel up to 1,024 tokens, K2's past it (no window:
T = L + 2). Geometric attention has no Pallas kernel in the JAX package
and stays PyTorch ops here. Its distance term, the norm of every
(query, key) difference of the per-head distance vectors, sums the
squared differences one coordinate at a time into the (B, H, T, T)
result, so the (B, T, T, H, 3) difference tensor of the JAX expression
is never made (the ||a||^2 + ||b||^2 - 2 a.b form would cancel at
Angstrom-scale translations; ``torch.cdist``'s exact-difference mode
gives each distance a thread block of its own and took most of a
forward).

Parameter names are the SDK's (``encoder.*``,
``transformer.blocks.N.{attn,geom_attn,ffn}``, ``transformer.norm``,
``output_heads.sequence_head.*``; the structure encoder's
``relative_positional_embedding.embedding``, ``pre_vq_proj``,
``codebook.embeddings``), so SDK state dicts load by name; only the
sequence head is held, the one scoring reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.models import esmc
from proteingym_tpu_torch.models.ar_zoo import _empty, _init_normal
from proteingym_tpu_torch.models.esm2 import LayerNorm
from proteingym_tpu_torch.models.state_dict import copy_state_dict

# token constants (ref esm/utils/constants/esm3.py:7-40)
SEQ_BOS, SEQ_PAD, SEQ_EOS = 0, 1, 2
SEQ_CHAINBREAK, SEQ_MASK = 31, 32
VQVAE_CODEBOOK_SIZE = 4096
STRUCT_MASK = VQVAE_CODEBOOK_SIZE
STRUCT_EOS = VQVAE_CODEBOOK_SIZE + 1
STRUCT_BOS = VQVAE_CODEBOOK_SIZE + 2
STRUCT_PAD = VQVAE_CODEBOOK_SIZE + 3
STRUCT_CHAINBREAK = VQVAE_CODEBOOK_SIZE + 4
SS8_PAD = 0
SASA_PAD = 0
INTERPRO_PAD = 0
RESIDUE_PAD = 0


@dataclasses.dataclass(frozen=True)
class Esm3Config:
    name: str = "esm3_open_small"
    d_model: int = 1536
    n_heads: int = 24
    v_heads: int = 256
    n_layers: int = 48
    n_layers_geom: int = 1
    seq_vocab: int = 64
    struct_vocab: int = VQVAE_CODEBOOK_SIZE + 5

    @property
    def residue_scaling(self) -> float:
        return float(np.sqrt(self.n_layers / 36))

    @property
    def ffn_hidden(self) -> int:
        return esmc._swiglu_hidden(8 / 3, self.d_model)


@dataclasses.dataclass(frozen=True)
class StructureEncoderConfig:
    name: str = "esm3_structure_encoder"
    d_model: int = 1024
    n_heads: int = 1
    v_heads: int = 128
    n_layers: int = 2
    d_out: int = 128
    n_codes: int = VQVAE_CODEBOOK_SIZE
    knn: int = 16
    relpos_bins: int = 32

    @property
    def ffn_hidden(self) -> int:
        return esmc._swiglu_hidden(4.0, self.d_model)


PRESETS = {"esm3_open_small": Esm3Config()}
STRUCTURE_ENCODER_PRESETS = {
    "esm3_structure_encoder": StructureEncoderConfig(),
    "esm3_structure_encoder_tiny": StructureEncoderConfig(
        name="esm3_structure_encoder_tiny", d_model=32, v_heads=4,
        n_layers=2, d_out=16, n_codes=64, knn=6,
    ),
}
TINY = Esm3Config(
    name="esm3_tiny", d_model=48, n_heads=4, v_heads=8, n_layers=2,
)

# ---------------------------------------------------------------------------
# Frames (affine3d.py)
# ---------------------------------------------------------------------------


def graham_schmidt(x_axis, xy_plane, eps=1e-12):
    """R with columns [x_hat, e1, e2] (ref affine3d.py:308-323)."""
    x = x_axis / torch.sqrt((x_axis ** 2).sum(-1, keepdim=True) + eps)
    e1 = xy_plane - x * (x * xy_plane).sum(-1, keepdim=True)
    e1 = e1 / torch.sqrt((e1 ** 2).sum(-1, keepdim=True) + eps)
    e2 = torch.linalg.cross(x, e1, dim=-1)
    return torch.stack([x, e1, e2], dim=-1)


def backbone_frames(bb):
    """from_graham_schmidt(C, CA, N): x axis CA - C, plane N - CA, origin
    CA (ref affine3d.py:288-299, 335-337)."""
    n, ca, c = bb[..., 0, :], bb[..., 1, :], bb[..., 2, :]
    return graham_schmidt(ca - c, n - ca, eps=1e-10), ca


def build_affine_from_coordinates(coords: torch.Tensor):
    """(B, L, 3, 3) N/CA/C -> R (B, L, 3, 3), t (B, L, 3), affine_mask
    (B, L). A residue has a frame when all nine coordinates are finite and
    < 1e6; the others take the average frame of the residues that have
    one, or the identity when none has (ref affine3d.py:326-374)."""
    coord_mask = (torch.isfinite(coords) & (coords < 1e6)).all(-1).all(-1)
    coords = torch.where(coord_mask[..., None, None], coords, 0.0)
    cm = coord_mask[..., None, None].to(coords.dtype)
    avg = (coords * cm).sum(1) / (coord_mask.sum(-1)[..., None, None] + 1e-8)  # (B, 3, 3)
    r_avg, t_avg = backbone_frames(avg)
    eye = torch.eye(3, dtype=coords.dtype, device=coords.device).expand_as(r_avg)
    r_bh = torch.where(coord_mask.any(-1)[:, None, None], r_avg, eye)
    r, t = backbone_frames(coords)
    return (torch.where(coord_mask[..., None, None], r, r_bh[:, None]),
            torch.where(coord_mask[..., None], t, t_avg[:, None]), coord_mask)


# ---------------------------------------------------------------------------
# Geometric attention (geom_attention.py:9-150)
# ---------------------------------------------------------------------------

SQRT3 = math.sqrt(3)


def rbf(values, v_min, v_max, n_bins=16):
    centers = torch.linspace(v_min, v_max, n_bins, device=values.device)
    std = (v_max - v_min) / n_bins
    z = (values[..., None] - centers) / std
    return torch.exp(-(z ** 2))


def distance_term(q_dist: torch.Tensor, k_dist: torch.Tensor) -> torch.Tensor:
    """(B, T, H, 3) query and key distance vectors -> (B, H, Tq, Tk) norms
    of their differences, sqrt(dx^2 + dy^2 + dz^2) summed in that order
    from the differences themselves, one coordinate at a time, without a
    (B, T, T, H, 3) tensor."""
    q, k = q_dist.permute(0, 2, 3, 1), k_dist.permute(0, 2, 3, 1)  # (B, H, 3, T)
    out = None
    for c in range(3):
        sq = (q[:, :, c, :, None] - k[:, :, c, None, :]).square_()
        out = sq if out is None else out.add_(sq)
        del sq
    return out.sqrt_()


class GeometricAttention(nn.Module):
    """The SDK's ``geom_attn`` (one vector message): per-head rotation and
    distance vectors in each residue's frame, scores
    rterm * softplus(rotation scale) - dterm * softplus(distance scale),
    keys without a frame masked by float32's lowest value, the values
    rotated back by R^T, rows without a frame zeroed."""

    def __init__(self, d: int, v_heads: int, bias: bool = False):
        super().__init__()
        self.v_heads = v_heads
        self.s_norm = LayerNorm(d)
        self.proj = nn.Linear(d, 4 * v_heads * 3 + v_heads * 3, bias=bias)
        self.out_proj = nn.Linear(v_heads * 3, d, bias=bias)
        self.distance_scale_per_head = nn.Parameter(torch.zeros(v_heads))
        self.rotation_scale_per_head = nn.Parameter(torch.zeros(v_heads))

    def forward(self, x, R, t, affine_mask, mask_and_zero_frameless=True):
        """x (B, T, D); R (B, T, 3, 3); t (B, T, 3); affine_mask (B, T)."""
        b, tt, _ = x.shape
        h = self.v_heads
        proj = self.proj(self.s_norm(x))
        vec_rot = proj[..., :9 * h].reshape(b, tt, 3 * h, 3)
        vec_dist = proj[..., 9 * h:].reshape(b, tt, 2 * h, 3)
        rt = R.transpose(-1, -2)
        rot = vec_rot @ rt  # R v for each head's vector
        dist = vec_dist @ rt + t[:, :, None, :]
        heads = lambda z: z.permute(0, 2, 1, 3)  # (B, T, H, 3) -> (B, H, T, 3)
        attn = heads(rot[:, :, :h]) @ heads(rot[:, :, h:2 * h]).transpose(-1, -2)
        attn.div_(SQRT3).mul_(F.softplus(self.rotation_scale_per_head)[None, :, None, None])
        dterm = distance_term(dist[:, :, :h], dist[:, :, h:])
        attn.sub_(dterm.div_(SQRT3).mul_(F.softplus(self.distance_scale_per_head)[None, :, None, None]))
        del dterm
        big = torch.finfo(torch.float32).min
        attn.add_(torch.where(affine_mask, 1.0, big)[:, None, None, :])
        w = torch.softmax(attn, dim=-1)
        del attn
        out = heads(w @ heads(rot[:, :, 2 * h:])) @ R  # R^T back
        out = out.reshape(b, tt, 3 * h)
        if mask_and_zero_frameless:
            out = torch.where(affine_mask[..., None], out, 0.0)
        return self.out_proj(out)


# ---------------------------------------------------------------------------
# Blocks and the ESM3 model
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """An SDK ``UnifiedTransformerBlock`` in float32: plain attention
    (``attn``), geometric attention (``geom_attn``), or both, then the
    SwiGLU ``ffn``; each branch added to the residual over ``scale``."""

    def __init__(self, d, n_heads, v_heads, ffn_hidden, bias, plain, geom):
        super().__init__()
        if plain:
            self.attn = esmc.Attention(d, n_heads, torch.float32, bias=bias)
        if geom:
            self.geom_attn = GeometricAttention(d, v_heads, bias=bias)
        self.ffn = esmc.swiglu_ffn(d, ffn_hidden, torch.float32, bias=bias)

    def forward(self, x, scale, R=None, t=None, affine_mask=None, mask_and_zero_frameless=True):
        if hasattr(self, "attn"):
            x = x + self.attn(x) / scale
        if hasattr(self, "geom_attn"):
            x = x + self.geom_attn(x, R, t, affine_mask, mask_and_zero_frameless) / scale
        return x + esmc.apply_swiglu_ffn(self.ffn, x) / scale


class Transformer(nn.Module):
    def __init__(self, blocks, d, norm=True):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        if norm:
            self.norm = LayerNorm(d)


class EncodeInputs(nn.Module):
    """The SDK's ``encoder`` (EncodeInputs, esm3.py:69-155)."""

    def __init__(self, c: Esm3Config):
        super().__init__()
        d = c.d_model
        self.sequence_embed = nn.Embedding(c.seq_vocab, d)
        self.plddt_projection = nn.Linear(16, d)
        self.structure_per_res_plddt_projection = nn.Linear(16, d)
        self.structure_tokens_embed = nn.Embedding(c.struct_vocab, d)
        self.ss8_embed = nn.Embedding(8 + 3, d)
        self.sasa_embed = nn.Embedding(16 + 3, d)
        self.function_embed = nn.ModuleList(nn.Embedding(260, d // 8) for _ in range(8))
        self.residue_embed = nn.Embedding(1478, d)

    def forward(self, sequence_tokens, structure_tokens, average_plddt, per_res_plddt,
                ss8_tokens, sasa_tokens, function_tokens=None, residue_tokens=None):
        x = self.sequence_embed(sequence_tokens)
        x = x + self.plddt_projection(rbf(average_plddt, 0.0, 1.0))
        x = x + self.structure_per_res_plddt_projection(rbf(per_res_plddt, 0.0, 1.0))
        x = x + self.structure_tokens_embed(structure_tokens)
        x = x + self.ss8_embed(ss8_tokens)
        x = x + self.sasa_embed(sasa_tokens)
        if function_tokens is not None:
            x = x + torch.cat([emb(function_tokens[..., k])
                               for k, emb in enumerate(self.function_embed)], dim=-1)
        if residue_tokens is not None:  # EmbeddingBag sum, padding_idx 0
            emb = self.residue_embed(residue_tokens)  # (B, L, N, D)
            x = x + torch.where((residue_tokens != RESIDUE_PAD)[..., None], emb, 0.0).sum(-2)
        return x


class OutputHeads(nn.Module):
    def __init__(self, c: Esm3Config):
        super().__init__()
        self.sequence_head = esmc.sdk_regression_head(c.d_model, 64)


class Esm3Model(nn.Module):
    """ESM3 (float32): ``forward`` returns the sequence logits (B, T, 64)
    and the pre-head embedding."""

    def __init__(self, config: Esm3Config):
        super().__init__()
        c = self.config = config
        self.encoder = EncodeInputs(c)
        self.transformer = Transformer(
            [Block(c.d_model, c.n_heads, c.v_heads, c.ffn_hidden, bias=False, plain=True,
                   geom=i < c.n_layers_geom) for i in range(c.n_layers)], c.d_model)
        self.output_heads = OutputHeads(c)

    def forward(self, sequence_tokens, structure_tokens=None, coords=None, ss8_tokens=None,
                sasa_tokens=None, average_plddt=None, per_res_plddt=None):
        """ESM3.forward with the reference's defaults and its remap of the
        sequence's special tokens onto structure tokens (esm3.py:307-382)."""
        b, t = sequence_tokens.shape
        dev = sequence_tokens.device
        full = lambda value, dtype: torch.full((b, t), value, dtype=dtype, device=dev)
        ss8_tokens = full(SS8_PAD, torch.long) if ss8_tokens is None else ss8_tokens
        sasa_tokens = full(SASA_PAD, torch.long) if sasa_tokens is None else sasa_tokens
        average_plddt = full(1.0, torch.float32) if average_plddt is None else average_plddt
        per_res_plddt = full(0.0, torch.float32) if per_res_plddt is None else per_res_plddt
        if coords is None:
            coords = torch.full((b, t, 3, 3), float("nan"), device=dev)
        R, tr, affine_mask = build_affine_from_coordinates(coords[..., :3, :])
        if structure_tokens is None:
            structure_tokens = full(STRUCT_MASK, torch.long)
        structure_tokens = torch.where(structure_tokens == -1, STRUCT_MASK, structure_tokens)
        for seq_tok, struct_tok in ((SEQ_BOS, STRUCT_BOS), (SEQ_PAD, STRUCT_PAD),
                                    (SEQ_EOS, STRUCT_EOS), (SEQ_CHAINBREAK, STRUCT_CHAINBREAK)):
            structure_tokens = torch.where(sequence_tokens == seq_tok, struct_tok,
                                           structure_tokens)
        x = self.encoder(sequence_tokens, structure_tokens, average_plddt, per_res_plddt,
                         ss8_tokens, sasa_tokens)
        for block in self.transformer.blocks:
            x = block(x, self.config.residue_scaling, R=R, t=tr, affine_mask=affine_mask)
        return self.output_heads.sequence_head(self.transformer.norm(x)), x


def _zero_geom_scales(model: nn.Module) -> nn.Module:
    for m in model.modules():
        if isinstance(m, GeometricAttention):
            m.distance_scale_per_head.data.zero_()
            m.rotation_scale_per_head.data.zero_()
    return model


def init_random(config: Esm3Config, seed: int = 0, device="cuda") -> Esm3Model:
    """Seeded random weights with the JAX ``init_params`` distribution (the
    draws differ): matrices and embeddings N(0, 0.02^2), zero biases and
    geometric scales, unit layer-norm scales."""
    return _zero_geom_scales(_init_normal(_empty(Esm3Model, config, device), seed))


def load_state_dict(state_dict: Mapping, config: Esm3Config, device="cuda") -> Esm3Model:
    """The model from a published ESM3 (esm3-open) state dict; entries it
    does not hold (the other output heads) are ignored, absent layer-norm
    biases are zero."""
    model = _empty(Esm3Model, config, device)
    return copy_state_dict(model, esmc._with_zero_biases(model, state_dict), config.name)


# ---------------------------------------------------------------------------
# The structure VQ-VAE encoder
# ---------------------------------------------------------------------------


class RelativePositionalEmbedding(nn.Module):
    def __init__(self, bins: int, d: int):
        super().__init__()
        self.embedding = nn.Embedding(2 * bins + 2, d)


class Codebook(nn.Module):
    def __init__(self, n_codes: int, d: int):
        super().__init__()
        self.embeddings = nn.Parameter(torch.empty(n_codes, d))


class StructureEncoder(nn.Module):
    """StructureTokenEncoder (vqvae.py:294-325): relative positions over kNN
    neighbourhoods, geometric-only blocks, the query node, ``pre_vq_proj``
    and the codebook."""

    def __init__(self, config: StructureEncoderConfig):
        super().__init__()
        c = self.config = config
        self.relative_positional_embedding = RelativePositionalEmbedding(c.relpos_bins, c.d_model)
        self.transformer = Transformer(
            [Block(c.d_model, c.n_heads, c.v_heads, c.ffn_hidden, bias=True, plain=False,
                   geom=True) for _ in range(c.n_layers)], c.d_model, norm=False)
        self.pre_vq_proj = nn.Linear(c.d_model, c.d_out)
        self.codebook = Codebook(c.n_codes, c.d_out)


def structure_encoder_init(config: StructureEncoderConfig, seed: int = 0,
                           device="cuda") -> StructureEncoder:
    """Seeded random weights with the JAX ``structure_encoder_init``
    distribution (the draws differ): N(0, 0.02^2) matrices and embeddings,
    an N(0, 1) codebook."""
    model = _empty(StructureEncoder, config, device)
    return _zero_geom_scales(_init_normal(model, seed, {"codebook.embeddings": 1.0}))


def load_structure_encoder_state_dict(state_dict: Mapping, config: StructureEncoderConfig,
                                      device="cuda") -> StructureEncoder:
    """The encoder from a published structure-encoder state dict."""
    model = _empty(StructureEncoder, config, device)
    return copy_state_dict(model, esmc._with_zero_biases(model, state_dict), config.name)


def knn_edges(ca: torch.Tensor, coord_mask: torch.Tensor, knn: int) -> torch.Tensor:
    """knn_graph (utils/misc.py:85-124): each residue's ``knn`` nearest by
    CA distance, pairs without coordinates at 100 |i - j| + 1e6; a stable
    sort, so self comes first and a tie keeps the lower index."""
    n = ca.shape[0]
    ca = torch.nan_to_num(ca)
    pair_invalid = ~(coord_mask[None, :] & coord_mask[:, None])
    d = torch.linalg.norm(ca[:, None] - ca[None, :], dim=-1)
    seq = torch.arange(n, device=ca.device)
    seq_d = (seq[:, None] - seq[None, :]).abs().to(d.dtype)
    adj = torch.where(pair_invalid, seq_d * 1e2 + 1e6, d)
    return torch.argsort(adj, dim=-1, stable=True)[:, :min(knn, n)]


@torch.no_grad()
def structure_code_distances(encoder: StructureEncoder, coords: np.ndarray,
                             residue_index: Optional[np.ndarray] = None) -> torch.Tensor:
    """(L, 3, 3) N/CA/C of one chain -> (L, n_codes) squared distances of
    each residue's ``pre_vq`` vector to every code,
    ||q||^2 - 2 q.c + ||c||^2 as the JAX function computes them."""
    c = encoder.config
    dev = encoder.codebook.embeddings.device
    coords = torch.as_tensor(np.asarray(coords, np.float32), device=dev)[None, :, :3]
    R, t, mask = (z[0] for z in build_affine_from_coordinates(coords))
    n = coords.shape[1]
    residue_index = (torch.arange(n, device=dev) + 1 if residue_index is None
                     else torch.as_tensor(residue_index, device=dev))
    edges = knn_edges(coords[0, :, 1], mask, c.knn)
    res_idx = residue_index[edges]
    diff = (res_idx - res_idx[:, :1]).clamp(-c.relpos_bins, c.relpos_bins) + c.relpos_bins + 1
    z = encoder.relative_positional_embedding.embedding(diff)  # (L, K, D)
    for block in encoder.transformer.blocks:
        z = block(z, 1.0, R=R[edges], t=t[edges], affine_mask=mask[edges],
                  mask_and_zero_frameless=False)
    q = encoder.pre_vq_proj(torch.where(mask[:, None], z[:, 0], 0.0))
    cb = encoder.codebook.embeddings
    return (q ** 2).sum(-1, keepdim=True) - 2 * q @ cb.t() + (cb ** 2).sum(-1)[None, :]


def structure_tokens_from_coords(encoder: StructureEncoder, coords: np.ndarray,
                                 residue_index: Optional[np.ndarray] = None) -> np.ndarray:
    """StructureTokenEncoder.encode (vqvae.py:294-325) for one chain:
    (L, 3, 3) N/CA/C -> (L,) int32 codebook indices."""
    d2 = structure_code_distances(encoder, coords, residue_index)
    return d2.argmin(-1).cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# Scoring: masked marginals, structure track fixed
# ---------------------------------------------------------------------------


def tokenize_sequence(seq: str) -> np.ndarray:
    return esmc.ALPHABET.tokenize(seq)


def prepare_tracks(encoder: Optional[StructureEncoder], seq: str,
                   coords: Optional[np.ndarray]):
    """[BOS] seq [EOS] tokens, and with coordinates the flanked structure
    tokens and coordinates (BOS and EOS at infinity, as
    ``tokenize_structure`` adds them)."""
    tokens = tokenize_sequence(seq)
    t = len(tokens)
    if coords is None:
        return tokens, None, None
    struct = structure_tokens_from_coords(encoder, coords)
    struct_tokens = np.full(t, STRUCT_PAD, np.int32)
    struct_tokens[0] = STRUCT_BOS
    struct_tokens[-1] = STRUCT_EOS
    struct_tokens[1:1 + len(struct)] = struct
    pc = np.full((t, 3, 3), np.inf, np.float32)
    pc[1:1 + len(coords)] = coords[:, :3]
    return tokens, struct_tokens, pc


@torch.no_grad()
def masked_logprob_table(model: Esm3Model, tokens: np.ndarray,
                         struct_tokens: Optional[np.ndarray], coords: Optional[np.ndarray],
                         positions: Sequence[int], batch: int = 8) -> np.ndarray:
    """(len(positions), 64) float32 log-softmax rows, each from a forward
    with its position (token coordinates) masked; ``batch`` rows a
    forward. ``per_res_plddt`` is 1 where a residue has coordinates."""
    dev = next(model.parameters()).device
    t = len(tokens)
    toks = torch.as_tensor(tokens, dtype=torch.long, device=dev)
    kw = {}
    if coords is not None:
        kw["per_res_plddt"] = torch.as_tensor(
            np.isfinite(coords).all(-1).any(-1).astype(np.float32), device=dev)[None]
        kw["coords"] = torch.as_tensor(coords, device=dev)[None]
        kw["structure_tokens"] = torch.as_tensor(struct_tokens, dtype=torch.long, device=dev)[None]
    out = np.zeros((len(positions), 64), np.float32)
    pos = list(positions)
    for s in range(0, len(pos), batch):
        blk = torch.as_tensor(pos[s:s + batch], device=dev)
        nb = len(blk)
        rows = toks.expand(nb, t).clone()
        lanes = torch.arange(nb, device=dev)
        rows[lanes, blk] = SEQ_MASK
        logits, _ = model(rows, **{k: v.expand(nb, *v.shape[1:]) for k, v in kw.items()})
        out[s:s + nb] = torch.log_softmax(logits[lanes, blk], dim=-1).cpu().numpy()
    return out


def score_assay_esm3(model: Esm3Model, encoder: Optional[StructureEncoder], sequence: str,
                     mutants: Sequence[str], coords: Optional[np.ndarray] = None,
                     batch: int = 8) -> np.ndarray:
    """Masked-marginal mutant scores, structure-conditioned when ``coords``
    ((L, 3, 3) N/CA/C) are given (ref evoscale/compute_fitness.py:296-470).
    A literal WT row scores 0; a wrong wild-type letter raises."""
    tokens, struct_tokens, pc = prepare_tracks(encoder, sequence, coords)
    positions = sorted(
        {int(tok[1:-1]) - 1 for m in mutants if m and m.lower() != "wt"
         for tok in m.replace(";", ":").split(":")}
    )
    table = masked_logprob_table(model, tokens, struct_tokens, pc,
                                 [p + 1 for p in positions], batch=batch)  # +1 for BOS
    row_of = {p: i for i, p in enumerate(positions)}
    aa_tok = {a: int(tokenize_sequence(a)[1]) for a in "ACDEFGHIKLMNPQRSTVWY"}
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        if not m or m.lower() == "wt":
            continue
        for tok in m.replace(";", ":").split(":"):
            wt, p, mt = tok[0], int(tok[1:-1]) - 1, tok[-1]
            if sequence[p] != wt:
                raise ValueError(f"WT mismatch in {tok}")
            row = table[row_of[p]]
            out[i] += row[aa_tok[mt]] - row[aa_tok[wt]]
    return out


# ---------------------------------------------------------------------------
# The JAX pytrees as SDK state dicts
# ---------------------------------------------------------------------------


def _sd_writer(sd: Dict[str, torch.Tensor]):
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))

    def put(key, value):
        sd[key] = a(value)

    def lin(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["w"]).T)
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def ln(prefix, p):
        put(f"{prefix}.weight", p["g"])
        if "b" in p:
            put(f"{prefix}.bias", p["b"])

    def block(prefix, layer):
        if "qkv" in layer:
            ln(f"{prefix}.attn.layernorm_qkv.0", layer["attn_ln"])
            lin(f"{prefix}.attn.layernorm_qkv.1", layer["qkv"])
            ln(f"{prefix}.attn.q_ln", layer["q_ln"])
            ln(f"{prefix}.attn.k_ln", layer["k_ln"])
            lin(f"{prefix}.attn.out_proj", layer["out"])
        ln(f"{prefix}.ffn.0", layer["ffn_ln"])
        lin(f"{prefix}.ffn.1", layer["ffn_in"])
        lin(f"{prefix}.ffn.3", layer["ffn_out"])
        if "geom" in layer:
            g, gp = layer["geom"], f"{prefix}.geom_attn"
            ln(f"{gp}.s_norm", g["s_norm"])
            lin(f"{gp}.proj", g["proj"])
            lin(f"{gp}.out_proj", g["out"])
            put(f"{gp}.distance_scale_per_head", g["dist_scale"])
            put(f"{gp}.rotation_scale_per_head", g["rot_scale"])

    return put, lin, ln, block


def params_from_jax(params, config: Esm3Config) -> Dict[str, torch.Tensor]:
    """The JAX ESM3 pytree (numpy leaves) as an SDK-named state dict (the
    sequence head only)."""
    sd: Dict[str, torch.Tensor] = {}
    put, lin, ln, block = _sd_writer(sd)
    e = params["encoder"]
    put("encoder.sequence_embed.weight", e["sequence_embed"])
    lin("encoder.plddt_projection", e["plddt_proj"])
    lin("encoder.structure_per_res_plddt_projection", e["per_res_plddt_proj"])
    put("encoder.structure_tokens_embed.weight", e["structure_embed"])
    put("encoder.ss8_embed.weight", e["ss8_embed"])
    put("encoder.sasa_embed.weight", e["sasa_embed"])
    for k, w in enumerate(e["function_embed"]):
        put(f"encoder.function_embed.{k}.weight", w)
    put("encoder.residue_embed.weight", e["residue_embed"])
    for i, layer in enumerate(params["layers"][:config.n_layers]):
        block(f"transformer.blocks.{i}", layer)
    ln("transformer.norm", params["final_ln"])
    head = params["heads"]["sequence"]
    lin("output_heads.sequence_head.0", head["dense"])
    ln("output_heads.sequence_head.2", head["ln"])
    lin("output_heads.sequence_head.3", head["out"])
    return sd


def structure_encoder_params_from_jax(params, config: StructureEncoderConfig
                                      ) -> Dict[str, torch.Tensor]:
    """The JAX structure-encoder pytree as an SDK-named state dict."""
    sd: Dict[str, torch.Tensor] = {}
    put, lin, _, block = _sd_writer(sd)
    put("relative_positional_embedding.embedding.weight", params["relpos"])
    for i, layer in enumerate(params["layers"][:config.n_layers]):
        block(f"transformer.blocks.{i}", layer)
    lin("pre_vq_proj", params["pre_vq"])
    put("codebook.embeddings", params["codebook"])
    return sd
