"""Tranception: a GPT-2-style autoregressive protein LM with grouped ALiBi
positions and depthwise convolutions on q/k/v, as a PyTorch module
(counterpart of proteingym_tpu/models/tranception.py).

Semantics match the JAX ``apply``:

- vocab 25: [UNK][CLS][SEP][PAD][MASK] + the 20 amino acids in
  ACDEFGHIKLMNPQRSTVWY order; a scoring row is [CLS] seq [SEP];
- grouped ALiBi: slopes computed for ``num_heads // 4`` heads and tiled x4,
  a key-position bias ``slope[h] * k`` (H, T) added to the scores;
- heads split into 4 groups; groups 1-3 pass q, k and v through causal
  depthwise convolutions of kernel 3, 5 and 7 (in float32), group 0 is
  untouched;
- pre-LN blocks with float32 layer norms, dense layers that take the
  model dtype in, accumulate in float32, round to the model dtype and then
  add the bias in it, a squared-ReLU MLP computed in float32, the final LN
  and float32 logits from the LM head tied to the token embedding.

Attention goes through the port's ``mha`` with the ALiBi bias, the padding
key mask and ``causal=True``: rows are at most ``n_ctx`` = 1,024 tokens,
so it is the grouped kernel (K1). When 1/sqrt(head_dim) is a power of two
(head dim 16 or 64: every preset) the model scales q itself, which is exact,
and K1 runs with ``sm_scale=1`` and no pre-pass.

Parameter names follow the HF Tranception checkpoints (``transformer.wte``,
``transformer.h.{i}.attn.c_attn``, ``...query_depthwiseconv.{0,1,2}.conv``,
``transformer.ln_f``); their dense weights are GPT-2 ``Conv1D`` (in, out)
matrices. Dense and embedding weights are held in ``config.dtype``; the
layer norms and the depthwise convolutions stay float32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.esm2 import LayerNorm
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.ops.flash_attention import KeyTiles, mha

AA_VOCAB = "ACDEFGHIKLMNPQRSTVWY"
CONV_KERNELS = (3, 5, 7)  # head groups 1-3


class TranceptionVocab:
    UNK, CLS, SEP, PAD, MASK = 0, 1, 2, 3, 4

    def __init__(self):
        self.tok_to_idx = {"[UNK]": 0, "[CLS]": 1, "[SEP]": 2, "[PAD]": 3, "[MASK]": 4}
        for i, aa in enumerate(AA_VOCAB):
            self.tok_to_idx[aa] = 5 + i

    def __len__(self):
        return 25

    def get_idx(self, c: str) -> int:
        return self.tok_to_idx.get(c, self.UNK)

    def tokenize(self, seq: str, pad_to: Optional[int] = None) -> np.ndarray:
        ids = [self.CLS] + [self.get_idx(c) for c in seq] + [self.SEP]
        if pad_to is not None:
            ids += [self.PAD] * (pad_to - len(ids))
        return np.asarray(ids, dtype=np.int32)


VOCAB = TranceptionVocab()


def sample_indeterminate(seq: str, rng: np.random.Generator) -> str:
    """Resample ambiguity codes: X -> any amino acid, B -> D/N, J -> I/L,
    Z -> E/Q (ref model_pytorch.py:930-938)."""
    table = {"X": AA_VOCAB, "B": "DN", "J": "IL", "Z": "EQ"}
    out = list(seq)
    for i, c in enumerate(out):
        if c in table:
            out[i] = table[c][rng.integers(0, len(table[c]))]
    return "".join(out)


@dataclasses.dataclass(frozen=True)
class TranceptionConfig:
    name: str = "tranception_large"
    num_layers: int = 36
    embed_dim: int = 1280
    num_heads: int = 20
    n_ctx: int = 1024
    vocab_size: int = 25
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.embed_dim


PRESETS: Dict[str, TranceptionConfig] = {
    "tranception_small": TranceptionConfig("tranception_small", 12, 768, 12),
    "tranception_medium": TranceptionConfig("tranception_medium", 24, 1024, 16),
    "tranception_large": TranceptionConfig("tranception_large", 36, 1280, 20),
}


# ---------------------------------------------------------------------------
# ALiBi
# ---------------------------------------------------------------------------

def get_slopes(n: int, mode: str = "grouped_alibi"):
    """The reference's slope schedule (ref :50-71)."""

    def power_of_2(n):
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * (start**i) for i in range(n)]

    def standard(n):
        if math.log2(n).is_integer():
            return power_of_2(n)
        closest = 2 ** math.floor(math.log2(n))
        return power_of_2(closest) + standard(2 * closest)[0::2][: n - closest]

    if mode == "grouped_alibi":
        return standard(n // 4) * 4
    return standard(n)


@functools.lru_cache(maxsize=32)
def alibi_bias(num_heads: int, seq_len: int, device="cpu") -> torch.Tensor:
    """(H, T) float32 key-position bias ``slope[h] * k``, the float32
    product the JAX package computes (cached: callers must not write it)."""
    slopes = np.asarray(get_slopes(num_heads, "grouped_alibi"), dtype=np.float32)
    bias = slopes[:, None] * np.arange(seq_len, dtype=np.float32)[None, :]
    return torch.from_numpy(bias).to(device)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Conv1D(nn.Module):
    """GPT-2's dense layer: an (in, out) weight. The product is taken in the
    input dtype (float32 accumulation, one rounding), then the bias is
    added in that dtype, as the JAX ``_dense``."""

    def __init__(self, n_in: int, n_out: int, dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(n_out, device=device, dtype=dtype))

    def forward(self, x):
        return torch.matmul(x, self.weight) + self.bias


class DepthwiseConv(nn.Module):
    """The weights of one causal depthwise convolution over head_dim
    channels, shared by the heads of a group (ref
    SpatialDepthWiseConvolution): float32 (hd, 1, K) and (hd,). The
    attention applies the nine of a layer in one convolution (``Attention.qkv``)."""

    def __init__(self, head_dim: int, kernel: int, device=None):
        super().__init__()
        self.conv = nn.Conv1d(head_dim, head_dim, kernel, groups=head_dim, device=device)


class Attention(nn.Module):
    def __init__(self, config: TranceptionConfig, device=None):
        super().__init__()
        d, hd = config.embed_dim, config.head_dim
        if config.num_heads % 4:
            raise ValueError(f"{config.num_heads} heads do not form 4 groups")
        self.num_heads, self.head_dim = config.num_heads, hd
        self.c_attn = Conv1D(d, 3 * d, config.dtype, device)
        self.c_proj = Conv1D(d, d, config.dtype, device)
        for name in ("query", "key", "value"):
            setattr(self, f"{name}_depthwiseconv", nn.ModuleList(
                DepthwiseConv(hd, kernel, device) for kernel in CONV_KERNELS))
        scale = hd ** -0.5
        # q takes the softmax scale itself when that is exact (a power of two)
        self.q_scale, self.sm_scale = ((scale, 1.0) if math.log2(scale).is_integer()
                                       else (1.0, scale))
        # the nine convolutions as one (fuse_convolutions); not in the state dict
        kmax, n_conv = max(CONV_KERNELS), 3 * len(CONV_KERNELS)
        self.register_buffer("conv_weight", torch.empty(n_conv * hd, 1, kmax, device=device),
                             persistent=False)
        self.register_buffer("conv_bias", torch.empty(n_conv * hd, device=device),
                             persistent=False)
        # load_state_dict sets the nine convolutions' parameters: fuse them again
        self.register_load_state_dict_post_hook(lambda module, keys: module.fuse_convolutions())

    @torch.no_grad()
    def fuse_convolutions(self):
        """Set ``conv_weight`` and ``conv_bias`` from the layer's nine
        convolutions (q, k, v x head groups 1-3, in that order): one float32
        (9 hd, 1, 7) weight and (9 hd,) bias, each kernel left-padded with
        zero taps to 7, which leaves a causal convolution unchanged, and q's
        times q_scale (a power of two, so the float32 sums scale exactly).
        The loaders and ``load_state_dict`` call it once the weights are
        set; call it again after writing a depthwise weight by hand."""
        kmax = max(CONV_KERNELS)
        weights, biases = [], []
        for scale, group in ((self.q_scale, self.query_depthwiseconv),
                             (1.0, self.key_depthwiseconv), (1.0, self.value_depthwiseconv)):
            for c in group:
                weights.append(F.pad(c.conv.weight, (kmax - c.conv.weight.shape[-1], 0)) * scale)
                biases.append(c.conv.bias * scale)
        self.conv_weight.copy_(torch.cat(weights))
        self.conv_bias.copy_(torch.cat(biases))

    def qkv(self, x):
        """(B, T, D) -> q, k, v, each (B, H, T, hd), views of one (B, T, 3,
        H, hd) tensor: the projection, whose head groups 1-3 the causal
        depthwise convolutions overwrite in place (in float32: one copy in,
        left-padded by 6, one convolution, one copy back), q times
        q_scale."""
        b, t, _ = x.shape
        h, hd = self.num_heads, self.head_dim
        grp = h // 4
        qkv = self.c_attn(x)
        groups = qkv.view(b, t, 3, 4, grp, hd)[:, :, :, 1:]
        kmax = self.conv_weight.shape[-1]
        buf = torch.empty((b, grp, 3, 3, hd, kmax - 1 + t), dtype=torch.float32, device=x.device)
        buf[..., :kmax - 1].zero_()
        buf[..., kmax - 1:].copy_(groups.permute(0, 4, 2, 3, 5, 1))
        y = F.conv1d(buf.view(b * grp, 9 * hd, -1), self.conv_weight, self.conv_bias,
                     groups=9 * hd)
        groups.copy_(y.view(b, grp, 3, 3, hd, t).permute(0, 5, 2, 3, 1, 4))
        heads = qkv.view(b, t, 3, h, hd)
        if self.q_scale != 1.0:
            heads[:, :, 0, :grp].mul_(self.q_scale)
        return tuple(heads[:, :, i].transpose(1, 2) for i in range(3))

    def forward(self, x, key_mask, bias, key_tiles):
        b, t, d = x.shape
        ctx = mha(*self.qkv(x), key_mask=key_mask, bias=bias, causal=True,
                  sm_scale=self.sm_scale, key_tiles=key_tiles)
        return self.c_proj(ctx.transpose(1, 2).reshape(b, t, d))


class MLP(nn.Module):
    def __init__(self, config: TranceptionConfig, device=None):
        super().__init__()
        self.c_fc = Conv1D(config.embed_dim, config.ffn_dim, config.dtype, device)
        self.c_proj = Conv1D(config.ffn_dim, config.embed_dim, config.dtype, device)

    def forward(self, x):
        # squared ReLU, in place: the square of a model-dtype number is exact
        # in float32, so one rounding of it equals the JAX float32 route
        y = torch.relu_(self.c_fc(x))
        return self.c_proj(y.mul_(y))


class Block(nn.Module):
    def __init__(self, config: TranceptionConfig, device=None):
        super().__init__()
        self.ln_1 = LayerNorm(config.embed_dim, device=device)
        self.attn = Attention(config, device)
        self.ln_2 = LayerNorm(config.embed_dim, device=device)
        self.mlp = MLP(config, device)

    def forward(self, x, key_mask, bias, key_tiles):
        x = x + self.attn(self.ln_1(x), key_mask, bias, key_tiles)
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, config: TranceptionConfig, device=None):
        super().__init__()
        self.wte = nn.Embedding(config.vocab_size, config.embed_dim, device=device,
                                dtype=config.dtype)
        self.h = nn.ModuleList(Block(config, device) for _ in range(config.num_layers))
        self.ln_f = LayerNorm(config.embed_dim, device=device)


class Tranception(nn.Module):
    """(B, T) int tokens -> (B, T, V) float32 logits (causal, ALiBi)."""

    def __init__(self, config: TranceptionConfig, device=None):
        super().__init__()
        self.config = config
        self.transformer = Transformer(config, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        b, t = tokens.shape
        if t > self.config.n_ctx:
            raise ValueError(f"{t} tokens: the model takes at most {self.config.n_ctx}")
        tr = self.transformer
        key_mask = tokens != VOCAB.PAD
        bias = alibi_bias(self.config.num_heads, t, tokens.device)
        tiles = KeyTiles(None, key_mask, True)  # one set of key-tile extents per forward
        x = tr.wte(tokens)
        for block in tr.h:
            x = block(x, key_mask, bias, tiles)
        x = tr.ln_f(x)
        # float32 product of the stored-dtype operands (the JAX head takes
        # them with float32 accumulation)
        return torch.matmul(x.float(), tr.wte.weight.float().t())


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _empty_model(config: TranceptionConfig, device) -> Tranception:
    with torch.device("meta"):
        model = Tranception(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


def _fuse_convolutions(model: Tranception) -> Tranception:
    for block in model.transformer.h:
        block.attn.fuse_convolutions()
    return model


@torch.no_grad()
def init_random(config: TranceptionConfig, seed: int = 0, device="cuda") -> Tranception:
    """Seeded random init with the JAX ``init_params`` distribution (the
    draws differ): the embedding, dense and depthwise-conv weights
    N(0, 0.02^2), zero biases, unit LN scales."""
    model = _empty_model(config, device)
    dev = model.transformer.wte.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, (Conv1D, nn.Conv1d, nn.Embedding)):
            w = module.weight
            w.copy_(torch.randn(tuple(w.shape), generator=gen, device=dev) * 0.02)
            if getattr(module, "bias", None) is not None:
                module.bias.zero_()
    return _fuse_convolutions(model)


def load_hf_state_dict(state_dict: Mapping, config: TranceptionConfig,
                       device="cuda") -> Tranception:
    """Build the model from an HF Tranception state dict (tensors or numpy
    arrays). Keys the model does not hold (the tied ``lm_head.weight``,
    attention mask buffers) are ignored; a key it needs and does not
    find, or one of another shape, raises."""
    return _fuse_convolutions(copy_state_dict(_empty_model(config, device), state_dict,
                                              config.name))


def params_from_jax(params, config: TranceptionConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as an HF-named state dict. JAX
    dense kernels are (in, out) as GPT-2's Conv1D; a depthwise kernel
    (K, hd) is the torch conv weight (hd, 1, K)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def dense(prefix, p):
        put(f"{prefix}.weight", p["kernel"])
        put(f"{prefix}.bias", p["bias"])

    def ln(prefix, p):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])

    put("transformer.wte.weight", params["wte"])
    ln("transformer.ln_f", params["ln_f"])
    for i, layer in enumerate(params["layers"][: config.num_layers]):
        p = f"transformer.h.{i}"
        ln(f"{p}.ln_1", layer["ln_1"])
        ln(f"{p}.ln_2", layer["ln_2"])
        dense(f"{p}.attn.c_attn", layer["c_attn"])
        dense(f"{p}.attn.c_proj", layer["c_proj"])
        dense(f"{p}.mlp.c_fc", layer["c_fc"])
        dense(f"{p}.mlp.c_proj", layer["c_proj_mlp"])
        for gi in range(len(CONV_KERNELS)):
            for name, ref in (("q", "query"), ("k", "key"), ("v", "value")):
                conv = layer["dwconv"][f"{name}{gi}"]
                put(f"{p}.attn.{ref}_depthwiseconv.{gi}.conv.weight",
                    np.asarray(conv["kernel"]).T[:, None, :])
                put(f"{p}.attn.{ref}_depthwiseconv.{gi}.conv.bias", conv["bias"])
    return sd
