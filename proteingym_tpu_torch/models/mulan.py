"""MULAN: an ESM2 trunk whose embeddings take a structure-angle adapter
(counterpart of proteingym_tpu/models/mulan.py; ref
proteingym/baselines/mulan/mulan/model.py:13-48, model_utils.py:59-190,
compute_fitness.py:27-127):

  struct = one position-free pre-LN encoder layer over Linear(7 angles -> d)
  embeddings = word_embeddings(tokens) + struct, before ESM's token dropout

The angles per residue are phi, psi and chi1-5 in radians, NaN filled
with deg2rad(182), the flanks and ragged slots 4.0 (tokenizer.py:27-58,
dataset.py:132-152). Scoring masks each mutated token and sets its angle
row to -4.0; score = sum of log(p_mt / p_wt) at those positions
(compute_fitness.py:27-77), ``batch_size`` mutants a forward.

The trunk is the port's ``esm2.EsmModel`` in float32 (K4 on the card);
the adapter's attention goes through ``mha`` with the pad key mask (K1).
Parameters: the trunk in fair-esm names under ``esm.``, the adapter in
transformers' names under ``struct_embeddings.``; ``load_torch_state_dict``
reads a ``StructEsmForMaskedLM`` state dict.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device, seeded_generator
from proteingym_tpu_torch.models import esm2
from proteingym_tpu_torch.models.state_dict import Named, copy_state_dict
from proteingym_tpu_torch.ops.flash_attention import mha
from proteingym_tpu_torch.ops.gvp import dihedral

NAN_FILL = float(np.deg2rad(182.0))
PAD_VALUE = 4.0
MASKED_ANGLE = -4.0
STRUCT_DIM = 7


@dataclasses.dataclass(frozen=True)
class MulanConfig:
    name: str = "mulan_small"
    esm: esm2.EsmConfig = dataclasses.replace(esm2.PRESETS["esm2_t12_35M"], dtype=torch.float32)
    struct_layers: int = 1
    struct_dim: int = STRUCT_DIM
    struct_final_ln: bool = False  # the adapter encoder's emb_layer_norm_after


PRESETS = {
    "mulan_small": MulanConfig(),
    "mulan_tiny": MulanConfig(name="mulan_tiny", esm=dataclasses.replace(
        esm2.PRESETS["esm2_t6_8M"], dtype=torch.float32)),
}


def _ln(d):
    return nn.LayerNorm(d, eps=1e-5)


class StructLayer(nn.Module):
    """One adapter encoder layer in transformers' EsmLayer names: pre-LN
    attention without positions, pre-LN exact-GELU feed-forward."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attention = Named(LayerNorm=_ln(d), self=Named(
            query=nn.Linear(d, d), key=nn.Linear(d, d), value=nn.Linear(d, d)),
            output=Named(dense=nn.Linear(d, d)))
        self.LayerNorm = _ln(d)
        self.intermediate = Named(dense=nn.Linear(d, 4 * d))
        self.output = Named(dense=nn.Linear(4 * d, d))

    def forward(self, x, key_mask):
        b, t, d = x.shape
        att = self.attention
        y = att.LayerNorm(x)

        def split(z):
            return z.view(b, t, self.heads, d // self.heads).transpose(1, 2)

        ctx = mha(split(att.self.query(y)), split(att.self.key(y)), split(att.self.value(y)),
                  key_mask=key_mask)
        x = x + att.output.dense(ctx.transpose(1, 2).reshape(b, t, d))
        y = F.gelu(self.intermediate.dense(self.LayerNorm(x)))
        return x + self.output.dense(y)


class StructEmbeddings(nn.Module):
    """StructEmbeddings (model_utils.py:59-97): ``MLP`` then the encoder."""

    def __init__(self, c: MulanConfig):
        super().__init__()
        d = c.esm.embed_dim
        self.MLP = nn.Linear(c.struct_dim, d)
        self.encoder = Named(layer=nn.ModuleList(
            StructLayer(d, c.esm.num_heads) for _ in range(c.struct_layers)))
        if c.struct_final_ln:
            self.encoder.emb_layer_norm_after = _ln(d)

    def forward(self, feats, key_mask):
        x = self.MLP(feats)
        for layer in self.encoder.layer:
            x = layer(x, key_mask)
        if hasattr(self.encoder, "emb_layer_norm_after"):
            x = self.encoder.emb_layer_norm_after(x)
        return x


class Mulan(nn.Module):
    """(B, T) tokens and (B, T, 7) angle features -> (B, T, V) float32 logits."""

    def __init__(self, c: MulanConfig):
        super().__init__()
        self.config = c
        self.esm = esm2.EsmModel(c.esm)
        self.struct_embeddings = StructEmbeddings(c)

    def forward(self, tokens, struct_feats):
        cond = self.struct_embeddings(struct_feats, tokens != esm2.ALPHABET.padding_idx)
        return self.esm(tokens, extra_embedding=cond)


def _empty(c: MulanConfig, device) -> Mulan:
    with torch.device("meta"):
        model = Mulan(c)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(c: MulanConfig, seed: int = 0, device="cuda") -> Mulan:
    """Seeded random weights: the trunk as ``esm2.init_random``, the
    adapter's matrices N(0, 0.02^2) from a second stream, zero biases, unit
    LN scales (the JAX ``init_params`` distribution; the draws differ)."""
    model = _empty(c, device)
    model.esm = esm2.init_random(c.esm, seed=seed, device=model.esm.embed_tokens.weight.device)
    dev = model.esm.embed_tokens.weight.device
    gen = seeded_generator(seed, dev, 1)
    for name, p in model.struct_embeddings.named_parameters():
        if p.dim() == 2:
            p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev) * 0.02)
        elif "LayerNorm" in name or "layer_norm" in name:
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        else:
            p.zero_()
    return model


def _tensor(value) -> torch.Tensor:
    return value if torch.is_tensor(value) else torch.from_numpy(np.asarray(value, np.float32))


STRUCT_PREFIX = "esm.embeddings.struct_embeddings."


@torch.no_grad()
def load_torch_state_dict(sd: Mapping, c: MulanConfig, device="cuda") -> Mulan:
    """The model from a ``StructEsmForMaskedLM`` state dict: the trunk in
    transformers' ESM names under ``esm.`` (``esm2.convert_hf_esm_state_dict``),
    the adapter under ``esm.embeddings.struct_embeddings.``, with its
    encoder's ``emb_layer_norm_after`` when the file has one."""
    final_ln = f"{STRUCT_PREFIX}encoder.emb_layer_norm_after.weight" in sd
    c = dataclasses.replace(c, struct_final_ln=final_ln)
    ours = {f"esm.{k}": v for k, v in esm2.convert_hf_esm_state_dict(sd, c.esm).items()}
    ours.update({"struct_embeddings." + k[len(STRUCT_PREFIX):]: _tensor(v) for k, v in sd.items()
                 if k.startswith(STRUCT_PREFIX)})
    return copy_state_dict(_empty(c, device), ours, c.name)


def params_from_jax(params, c: MulanConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) in the model's names."""
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))  # noqa: E731
    sd = {f"esm.{k}": v for k, v in esm2.params_from_jax(params["esm"], c.esm).items()}

    def dense(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = a(np.asarray(p["kernel"]).T), a(p["bias"])

    def ln(prefix, p):
        sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = a(p["scale"]), a(p["bias"])

    st = params["struct"]
    dense("struct_embeddings.MLP", st["mlp"])
    for i, layer in enumerate(st["layers"]):
        p = f"struct_embeddings.encoder.layer.{i}"
        ln(f"{p}.attention.LayerNorm", layer["attn_ln"])
        for ours, key in (("query", "q"), ("key", "k"), ("value", "v")):
            dense(f"{p}.attention.self.{ours}", layer[key])
        dense(f"{p}.attention.output.dense", layer["out"])
        ln(f"{p}.LayerNorm", layer["ffn_ln"])
        dense(f"{p}.intermediate.dense", layer["fc1"])
        dense(f"{p}.output.dense", layer["fc2"])
    if "final_ln" in st:
        ln("struct_embeddings.encoder.emb_layer_norm_after", st["final_ln"])
    return sd


def build_struct_features(angles: np.ndarray) -> np.ndarray:
    """(L, <= 7) angles in radians -> the (L + 2, 7) grid: NaN filled with
    deg2rad(182), 4.0 at the flanks and ragged slots (dataset.py:132-147)."""
    L = angles.shape[0]
    out = np.full((L + 2, STRUCT_DIM), PAD_VALUE, np.float32)
    k = min(angles.shape[1], STRUCT_DIM)
    out[1:1 + L, :k] = np.where(np.isnan(angles[:, :k]), NAN_FILL, angles[:, :k])
    return out


def backbone_angle_features(coords: np.ndarray) -> np.ndarray:
    """(L, 7) angles from an N/CA/C backbone: phi and psi; chi1-5 need side
    chains the PDB reader does not keep and stay NaN (the reference's
    fill), as do phi of the first and psi of the last residue."""
    n, ca, cc = coords[:, 0], coords[:, 1], coords[:, 2]
    L = len(coords)
    ang = np.full((L, STRUCT_DIM), np.nan, np.float64)
    if L >= 2:
        ang[1:, 0] = dihedral(cc[:-1], n[1:], ca[1:], cc[1:], floor=1e-9)
        ang[:-1, 1] = dihedral(n[:-1], ca[:-1], cc[:-1], n[1:], floor=1e-9)
    return ang


def score_mutants(model: Mulan, sequence: str, angles: np.ndarray, mutants: Sequence[str],
                  offset_idx: int = 1, batch_size: int = 8) -> np.ndarray:
    """Batched predict_mut (compute_fitness.py:27-77): each mutant's tokens
    masked and angle rows set to -4.0 at its positions, ``batch_size``
    mutants a forward, score = sum of log(p_mt / max(p_wt, 1e-30)) from the
    float32 softmax."""
    A = esm2.ALPHABET
    dev = model.esm.embed_tokens.weight.device
    base_tokens = A.tokenize(sequence).astype(np.int64)
    base_feats = build_struct_features(angles)
    out = np.zeros(len(mutants))
    for s in range(0, len(mutants), batch_size):
        blk = mutants[s:s + batch_size]
        toks = np.tile(base_tokens[None], (len(blk), 1))
        feats = np.tile(base_feats[None], (len(blk), 1, 1))
        for bi, m in enumerate(blk):
            for tok in m.split(":"):
                pos = int(tok[1:-1]) - offset_idx + 1  # +1 for CLS
                if sequence[pos - 1] != tok[0]:
                    raise ValueError(f"WT mismatch in {tok}")
                toks[bi, pos] = A.mask_idx
                feats[bi, pos] = MASKED_ANGLE
        with torch.no_grad():
            logits = model(torch.as_tensor(toks, device=dev), torch.as_tensor(feats, device=dev))
        probs = torch.softmax(logits.float(), -1).cpu().numpy()
        for bi, m in enumerate(blk):
            score = 0.0
            for tok in m.split(":"):
                wt, pos, mt = tok[0], int(tok[1:-1]) - offset_idx + 1, tok[-1]
                p_wt = probs[bi, pos, A.get_idx(wt)]
                p_mt = probs[bi, pos, A.get_idx(mt)]
                score += np.log(p_mt / max(p_wt, 1e-30))
            out[s + bi] = score
    return out

