"""ESM-C (and ESM3-open's sequence track), the EvolutionaryScale masked LM,
as a PyTorch module (counterpart of proteingym_tpu/models/esmc.py; ref
proteingym/baselines/evoscale/compute_fitness.py:20-291,
esm/layers/blocks.py:15-120, attention.py):

- blocks: x += attn(x) / scale; x += ffn(x) / scale, with scale 1 (ESM-C)
  or sqrt(n_layers / 36) (ESM3's residue scaling);
- attention: LayerNorm -> fused qkv (no bias) -> per-channel q/k
  LayerNorm -> rotary over the whole head -> softmax attention over the
  non-pad keys -> out projection;
- ffn: LayerNorm -> linear to 2h (no bias) -> SwiGLU -> linear, h rounded
  up to a multiple of 256;
- a final LayerNorm without bias; an untied head, or the SDK's
  RegressionHead (Linear -> exact GELU -> LayerNorm -> Linear);
- the vocabulary in ESM3's ``SEQUENCE_VOCAB`` order (4 specials, then
  'LAGVSERTIDPKQNFYMHWC', X B U Z O . - |, <mask> = 32, pad = 1).

Numerics follow the JAX ``apply``: layer norms in float32 statistics with
float32 parameters, rounded back to the input dtype; every product takes
the model dtype in and accumulates in float32 (``ar_zoo.matmul_f32``),
the qkv, out and ffn-out products rounded once to the model dtype, the
SwiGLU in float32; the rotary in float32, rounded to the model dtype; the
head in full float32. Attention goes through the port's ``mha`` (K1 on
the card, bidirectional with the pad mask here; causal for xTrimoPGLM's
AR mode).

Parameter names are the SDK's (``embed``,
``transformer.blocks.N.attn.layernorm_qkv.{0,1}``, ``q_ln``, ``k_ln``,
``out_proj``, ``ffn.{0,1,3}``, ``transformer.norm``, ``sequence_head.{0,2,3}``
or ``lm_head``), so an SDK state dict loads by name; a layer-norm bias the
file lacks is zero, which is the JAX ``_ln`` without it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.models.ar_zoo import Linear, _empty, _init_normal, matmul_f32
from proteingym_tpu_torch.models.esm2 import LayerNorm
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.ops.flash_attention import KeyTiles, mha
from proteingym_tpu_torch.ops.rotary import apply_rotary_bhtd

SEQUENCE_VOCAB = (
    ["<cls>", "<pad>", "<eos>", "<unk>"]
    + list("LAGVSERTIDPKQNFYMHWC")
    + ["X", "B", "U", "Z", "O", ".", "-", "|", "<mask>"]
)


class EsmcAlphabet:
    def __init__(self):
        self.tok_to_idx = {t: i for i, t in enumerate(SEQUENCE_VOCAB)}
        self.cls_idx = 0
        self.padding_idx = 1
        self.eos_idx = 2
        self.unk_idx = 3
        self.mask_idx = self.tok_to_idx["<mask>"]

    def __len__(self):
        return len(SEQUENCE_VOCAB)

    def get_idx(self, tok: str) -> int:
        return self.tok_to_idx.get(tok, self.unk_idx)

    def tokenize(self, seq: str, pad_to: Optional[int] = None) -> np.ndarray:
        ids = [self.cls_idx] + [self.get_idx(c) for c in seq] + [self.eos_idx]
        if pad_to is not None:
            ids += [self.padding_idx] * (pad_to - len(ids))
        return np.asarray(ids, np.int32)


ALPHABET = EsmcAlphabet()


def _swiglu_hidden(expansion: float, d: int) -> int:
    return int(((expansion * d) + 255) // 256 * 256)


@dataclasses.dataclass(frozen=True)
class EsmcConfig:
    name: str = "esmc_600m"
    num_layers: int = 36
    embed_dim: int = 1152
    num_heads: int = 18
    expansion_ratio: float = 8 / 3
    residue_scaling: float = 1.0  # ESM3: sqrt(n_layers / 36)
    alphabet_size: int = 33
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self):
        return self.embed_dim // self.num_heads

    @property
    def ffn_hidden(self):
        return _swiglu_hidden(self.expansion_ratio, self.embed_dim)


PRESETS = {
    "esmc_tiny": EsmcConfig("esmc_tiny", 2, 64, 4),
    "esmc_300m": EsmcConfig("esmc_300m", 30, 960, 15),
    "esmc_600m": EsmcConfig("esmc_600m", 36, 1152, 18),
    "esm3_open_1.4b_seq": EsmcConfig(
        "esm3_open_1.4b_seq", 48, 1536, 24,
        residue_scaling=float(np.sqrt(48 / 36)),
    ),
}


class SwiGLU(nn.Module):
    def forward(self, h):
        h1, h2 = h.chunk(2, dim=-1)
        return F.silu(h1) * h2


def swiglu_ffn(d: int, hidden: int, dtype, bias: bool = False) -> nn.Sequential:
    """The SDK's ``ffn``: LayerNorm, Linear(d, 2h), SwiGLU, Linear(h, d)."""
    return nn.Sequential(LayerNorm(d), Linear(d, 2 * hidden, dtype, bias=bias), SwiGLU(),
                         Linear(hidden, d, dtype, bias=bias))


def apply_swiglu_ffn(ffn: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """``ffn(x)`` as the JAX ``apply`` computes it: the 2h-wide product kept
    in float32 (plus its bias, if any), the SwiGLU in float32, rounded to
    the model dtype for the last product."""
    ln, lin1, act, lin2 = ffn
    h = matmul_f32(ln(x), lin1.weight.t())
    if lin1.bias is not None:
        h = h + lin1.bias
    return lin2(act(h).to(x.dtype))


class Attention(nn.Module):
    """The SDK's ``attn``: ``layernorm_qkv`` (LayerNorm, fused Linear),
    ``q_ln`` / ``k_ln`` over the whole width, rotary, attention,
    ``out_proj``."""

    def __init__(self, d: int, num_heads: int, dtype, bias: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.layernorm_qkv = nn.Sequential(LayerNorm(d), Linear(d, 3 * d, dtype, bias=bias))
        self.q_ln = LayerNorm(d)
        self.k_ln = LayerNorm(d)
        self.out_proj = Linear(d, d, dtype, bias=bias)

    def forward(self, x, key_mask=None, causal=False, key_tiles=None):
        b, t, d = x.shape
        q, k, v = self.layernorm_qkv(x).chunk(3, dim=-1)
        heads = lambda z: z.reshape(b, t, self.num_heads, d // self.num_heads).transpose(1, 2)
        q, k = apply_rotary_bhtd(heads(self.q_ln(q)), heads(self.k_ln(k)))
        ctx = mha(q, k, heads(v), key_mask=key_mask, causal=causal, key_tiles=key_tiles)
        return self.out_proj(ctx.transpose(1, 2).reshape(b, t, d))


class Block(nn.Module):
    def __init__(self, c: EsmcConfig):
        super().__init__()
        self.attn = Attention(c.embed_dim, c.num_heads, c.dtype)
        self.ffn = swiglu_ffn(c.embed_dim, c.ffn_hidden, c.dtype)

    def forward(self, x, key_mask, causal, scale, key_tiles=None):
        x = x + self.attn(x, key_mask, causal, key_tiles) / scale
        return x + apply_swiglu_ffn(self.ffn, x) / scale


class Transformer(nn.Module):
    def __init__(self, c: EsmcConfig):
        super().__init__()
        self.blocks = nn.ModuleList(Block(c) for _ in range(c.num_layers))
        self.norm = LayerNorm(c.embed_dim)


def sdk_regression_head(d: int, n_out: int) -> nn.Sequential:
    """The SDK's RegressionHead in float32: Linear(d, d), exact GELU,
    LayerNorm, Linear(d, n_out)."""
    return nn.Sequential(nn.Linear(d, d), nn.GELU(), LayerNorm(d), nn.Linear(d, n_out))


class EsmcModel(nn.Module):
    """(B, T) tokens -> (B, T, V) float32 logits. ``regression_head``
    chooses the SDK's ``sequence_head`` over a single ``lm_head`` matrix."""

    def __init__(self, config: EsmcConfig, regression_head: bool = False):
        super().__init__()
        self.config = config
        d, v = config.embed_dim, config.alphabet_size
        self.embed = nn.Embedding(v, d, dtype=config.dtype)
        self.transformer = Transformer(config)
        if regression_head:
            self.sequence_head = sdk_regression_head(d, v)
        else:
            self.lm_head = nn.Linear(d, v, bias=False)

    def trunk(self, tokens: torch.Tensor, causal: bool = False) -> torch.Tensor:
        """The final layer norm's output in float32, attention over the
        non-pad keys (and causal with ``causal``). A causal forward finds
        the bfloat16 kernel's key-tile extents once for all its layers."""
        key_mask = tokens != ALPHABET.padding_idx
        key_tiles = KeyTiles(None, key_mask, True) if causal else None
        x = self.embed(tokens)
        for block in self.transformer.blocks:
            x = block(x, key_mask, causal, self.config.residue_scaling, key_tiles)
        return self.transformer.norm(x).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.trunk(tokens)
        if hasattr(self, "sequence_head"):
            return self.sequence_head(x)
        return self.lm_head(x)


def init_random(config: EsmcConfig, seed: int = 0, device="cuda") -> EsmcModel:
    """Seeded random weights with the JAX ``init_params`` distribution (the
    draws differ): every matrix N(0, 0.02^2), unit layer-norm scales, zero
    biases, the single ``lm_head``."""
    return _init_normal(_empty(EsmcModel, config, device), seed)


def _with_zero_biases(model: nn.Module, state_dict: Mapping) -> Dict:
    """``state_dict`` with a zero entry for every bias the model holds and
    the file lacks: the SDK's bias-free layer norms and head, which the JAX
    converter leaves out and its ``_ln`` / head then skip."""
    sd = dict(state_dict)
    for key, p in model.state_dict().items():
        if key.endswith(".bias") and key not in sd:
            sd[key] = torch.zeros(p.shape)
    return sd


def load_state_dict(state_dict: Mapping, config: EsmcConfig, device="cuda") -> EsmcModel:
    """The model from an SDK ESM-C / ESM3 sequence-track state dict
    (tensors or numpy arrays): the RegressionHead when it has
    ``sequence_head.0.weight``, else ``lm_head``."""
    model = _empty(functools.partial(EsmcModel, regression_head="sequence_head.0.weight"
                                     in state_dict), config, device)
    return copy_state_dict(model, _with_zero_biases(model, state_dict), config.name)


def params_from_jax(params, config: EsmcConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as an SDK-named state dict:
    (in, out) matrices become (out, in) ``Linear`` weights."""
    sd: Dict[str, torch.Tensor] = {}
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = a(p["g"])
        if "b" in p:
            sd[f"{prefix}.bias"] = a(p["b"])

    sd["embed.weight"] = a(params["embed"])
    ln("transformer.norm", params["final_ln"])
    if "head_dense" in params:
        sd["sequence_head.0.weight"] = a(np.asarray(params["head_dense"]).T)
        sd["sequence_head.0.bias"] = a(params["head_dense_b"])
        ln("sequence_head.2", params["head_ln"])
        sd["sequence_head.3.weight"] = a(np.asarray(params["head"]).T)
        if "head_b" in params:
            sd["sequence_head.3.bias"] = a(params["head_b"])
    else:
        sd["lm_head.weight"] = a(np.asarray(params["head"]).T)
    for i, layer in enumerate(params["layers"][:config.num_layers]):
        p = f"transformer.blocks.{i}"
        ln(f"{p}.attn.layernorm_qkv.0", layer["attn_ln"])
        sd[f"{p}.attn.layernorm_qkv.1.weight"] = a(np.asarray(layer["qkv"]).T)
        ln(f"{p}.attn.q_ln", layer["q_ln"])
        ln(f"{p}.attn.k_ln", layer["k_ln"])
        sd[f"{p}.attn.out_proj.weight"] = a(np.asarray(layer["out"]).T)
        ln(f"{p}.ffn.0", layer["ffn_ln"])
        sd[f"{p}.ffn.1.weight"] = a(np.asarray(layer["ffn_in"]).T)
        sd[f"{p}.ffn.3.weight"] = a(np.asarray(layer["ffn_out"]).T)
    return sd


def score_assay(
    model: EsmcModel,
    sequence: str,
    mutants: Sequence[str],
    strategy: str = "masked-marginals",
    chunk: int = 16,
    window: int = 1024,
) -> np.ndarray:
    """Marginal scores with the ESM harness (``models/esm_scoring.py``) and
    the ESM-C alphabet: masked marginals with rows padded to a multiple of
    64 with ESM-C's pad, or WT marginals, stitched from overlapping windows
    past ``window`` tokens. A literal WT row scores 0."""
    from proteingym_tpu_torch.models.esm_scoring import (
        masked_marginal_table, score_mutants_from_table, wt_marginal_table_overlapping,
    )

    tokens = ALPHABET.tokenize(sequence)
    if strategy == "wt-marginals":
        table = wt_marginal_table_overlapping(model, tokens, window=window)
    else:
        table = masked_marginal_table(
            model, tokens, mask_idx=ALPHABET.mask_idx, chunk=chunk, window=window,
            pad_to_multiple=64, pad_idx=ALPHABET.padding_idx,
        )
    return score_mutants_from_table(table, mutants, sequence, alphabet=ALPHABET)
