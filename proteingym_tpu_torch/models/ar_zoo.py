"""The autoregressive protein LM zoo: ProGen2 (GPT-J layout), RITA and
ProtGPT2 (stock GPT-2), as PyTorch modules (counterpart of
proteingym_tpu/models/ar_zoo.py). Each feeds the AR harness
(``models/ar_scoring.py``) through a tokenizer and a (B, T) -> (B, T, V)
logits callable.

- ProGen2 (ref progen2/models/progen/modeling_progen.py): one ``ln_1`` per
  block feeding attention and MLP in parallel, x = attn(ln(x)) + mlp(ln(x))
  + x; a fused bias-free qkv projection in GPT-J's ``mp_num`` = 8 shard
  interleave, split in the order q, v, k; interleaved ("rotate_every_two")
  rotary on the first ``rotary_dim`` dims of each head; a float32 lm_head
  with bias; scoring restricts the logits to token ids 5..29, the amino
  acids (``restricted_logits``).
- RITA (ref rita/rita_modeling.py): pre-LN blocks, rotary over the whole
  head ("rotate_half"), separate q/k/v projections with bias, a GELU MLP,
  a final LayerNorm and an untied float32 lm_head.
- ProtGPT2: GPT-2 with learned positions and the head tied to the token
  embedding, over the 50,257-token BPE vocabulary.

Numerics follow the JAX functions: layer norms in float32 with float32
parameters, returned in the model dtype; each dense layer takes the model
dtype in, multiplies by its weight in that dtype with float32 accumulation,
adds a float32 bias and rounds once to the model dtype (``matmul_f32``: on
the card a bf16 product stays on the tensor cores with a float32 output);
the tanh GELU in float32. The JAX model keeps float32 master weights and
casts each to the model dtype where it is used; the port stores that cast
once, which gives the same numbers. The heads that the JAX model runs in
float32 (ProGen2's and RITA's lm_head) keep float32 weights and run in full
float32 (torch's default for a float32 ``matmul``, TF32 off).

Attention: q/k/v are cast to float32 and go through the port's
``mha(..., causal=True)``, whose float32 path is the kernel of
``ops/csrc/grouped_attention.cuh`` on the card (head dims 64-256 here),
and the result is cast back to the model dtype, as the JAX
``_causal_attend`` does.

Parameter names are the published torch layouts: ProGen2's
``transformer.h.N.attn.qkv_proj``, RITA's
``transformer.layers.N.self_attention.query``, GPT-2's ``Conv1D`` (in,
out) weights. ``params_from_jax`` turns a JAX params pytree into them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.esm2 import LayerNorm
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.ops.flash_attention import mha

# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., n) @ w (n, m), both in one dtype, accumulated and returned in
    float32: the JAX ``jnp.dot(..., preferred_element_type=float32)``. On
    the card a bf16 product runs on the tensor cores with a float32 output
    (``torch.mm``'s ``out_dtype``); float32 runs in full float32."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    lead, n = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, n)
    y = (torch.mm(x2, w, out_dtype=torch.float32) if x.is_cuda
         else torch.mm(x2.float(), w.float()))  # exact products of bf16 values
    return y.view(*lead, w.shape[-1])


class Linear(nn.Module):
    """A dense layer with a torch ``Linear`` (out, in) weight in ``dtype``
    and a float32 bias: the JAX ``_dense`` (see the module docstring)."""

    def __init__(self, n_in: int, n_out: int, dtype, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x):
        y = matmul_f32(x, self.weight.t())
        if self.bias is not None:
            y = y + self.bias
        return y.to(x.dtype)


class Conv1D(nn.Module):
    """GPT-2's dense layer: ``Linear``'s function with an (in, out) weight."""

    def __init__(self, n_in: int, n_out: int, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(n_out))

    def forward(self, x):
        return (matmul_f32(x, self.weight) + self.bias).to(x.dtype)


class TanhGelu(nn.Module):
    """The tanh GELU in float32, returned in the input dtype."""

    def forward(self, x):
        return F.gelu(x.float(), approximate="tanh").to(x.dtype)


def causal_attend(q, k, v):
    """(B, T, H, hd) q/k/v in the model dtype -> (B, T, H * hd): causal
    attention on float32 operands, cast back to the model dtype."""
    b, t = q.shape[:2]
    tr = lambda z: z.float().transpose(1, 2)
    ctx = mha(tr(q), tr(k), tr(v), causal=True)
    return ctx.to(q.dtype).transpose(1, 2).reshape(b, t, -1)


@functools.lru_cache(maxsize=64)
def _rope_np(t: int, dim: int, interleaved: bool):
    """float64 (T, dim) cos and sin: GPT-J's interleaved frequencies (each
    repeated twice) or rotate_half's halves, as the JAX ``_rope_tables``."""
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2) / dim))
    freqs = np.einsum("i,j->ij", np.arange(t), inv_freq)
    emb = (np.repeat(freqs, 2, axis=-1) if interleaved
           else np.concatenate([freqs, freqs], axis=-1))
    return np.cos(emb), np.sin(emb)


def rope_tables(t: int, dim: int, interleaved: bool, dtype, device):
    """(T, dim) cos and sin in ``dtype`` on ``device`` (the JAX tables are
    float32 and cast to the model dtype where they are applied)."""
    cos, sin = _rope_np(t, dim, interleaved)
    as_t = lambda a: torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=dtype)
    return as_t(cos), as_t(sin)


def rotate_every_two(x):
    """GPT-J's pairwise rotation: (x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).flatten(-2)


def rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(x, cos, sin, interleaved: bool):
    """x (B, T, H, dim) in the model dtype; cos/sin (T, dim) in it too."""
    rot = rotate_every_two(x) if interleaved else rotate_half(x)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def _empty(cls, config, device):
    with torch.device("meta"):
        model = cls(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def _init_normal(model: nn.Module, seed: int, scales: Mapping[str, float] = {}) -> nn.Module:
    """The JAX ``*_init`` distributions (the draws differ): every dense and
    embedding weight N(0, 0.02^2) (or ``scales[name]``), zero biases, unit
    LayerNorm scales."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if isinstance(_owner(model, name), LayerNorm):
            p.fill_(1.0 if name.endswith("weight") else 0.0)
        elif name.endswith("bias"):
            p.zero_()
        else:
            for chunk in p.view(-1, p.shape[-1]).split(4096):  # float32 draws, bounded
                chunk.copy_(torch.randn(tuple(chunk.shape), generator=gen, device=dev)
                            * scales.get(name, 0.02))
    return model


def _owner(model: nn.Module, name: str) -> nn.Module:
    return model.get_submodule(name.rsplit(".", 1)[0])


def _prefixed(state_dict: Mapping, prefix: str, keep=("lm_head.",)) -> Dict:
    """The state dict with every key under ``prefix`` (a published file may
    come with or without it), keys starting with one of ``keep`` as they
    are."""
    if any(k.startswith(prefix) for k in state_dict):
        return dict(state_dict)
    return {(k if k.startswith(keep) else prefix + k): v for k, v in state_dict.items()}


def _np32(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))

# ---------------------------------------------------------------------------
# ProGen2
# ---------------------------------------------------------------------------

# tokenizer.json vocabulary: specials, the terminals, then 25 letters
PROGEN2_TOKENS = (["<|pad|>", "<|bos|>", "<|eos|>", "1", "2"]
                  + list("ABCDEFGHIKLMNOPQRSTUVWXYZ"))
PROGEN2_AA_FIRST, PROGEN2_AA_LAST = 5, 29  # ref compute_fitness.py:70-71


class ProGen2Tokenizer:
    PAD = 0

    def __init__(self):
        self.tok_to_idx = {t: i for i, t in enumerate(PROGEN2_TOKENS)}

    def encode(self, seq: str) -> np.ndarray:
        return np.asarray([self.tok_to_idx[c] for c in seq if c in self.tok_to_idx],
                          dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class ProGen2Config:
    name: str = "progen2-small"
    num_layers: int = 12
    embed_dim: int = 1024
    num_heads: int = 16
    rotary_dim: int = 32
    vocab_size: int = 32
    n_ctx: int = 1024
    mp_num: int = 8  # GPT-J qkv shard interleave
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


PROGEN2_PRESETS = {
    "progen2-small": ProGen2Config("progen2-small", 12, 1024, 16),
    "progen2-medium": ProGen2Config("progen2-medium", 27, 1536, 16),
    "progen2-base": ProGen2Config("progen2-base", 27, 1536, 16),
    "progen2-large": ProGen2Config("progen2-large", 32, 2560, 16),
    "progen2-xlarge": ProGen2Config("progen2-xlarge", 32, 4096, 16, 64),
}


class ProGen2Attention(nn.Module):
    def __init__(self, c: ProGen2Config):
        super().__init__()
        self.c = c
        self.qkv_proj = Linear(c.embed_dim, 3 * c.embed_dim, c.dtype, bias=False)
        self.out_proj = Linear(c.embed_dim, c.embed_dim, c.dtype, bias=False)

    def forward(self, y, cos, sin):
        c = self.c
        b, t, _ = y.shape
        rd = c.rotary_dim
        # GPT-J's shard layout: (B, T, mp, 3 * local), split q, VALUE, k
        # (ref modeling_progen.py:164)
        qkv = self.qkv_proj(y).view(b, t, c.mp_num, -1)
        q, v, k = (z.reshape(b, t, c.num_heads, c.head_dim) for z in qkv.chunk(3, dim=-1))
        q = torch.cat([apply_rope(q[..., :rd], cos, sin, True), q[..., rd:]], dim=-1)
        k = torch.cat([apply_rope(k[..., :rd], cos, sin, True), k[..., rd:]], dim=-1)
        return self.out_proj(causal_attend(q, k, v))


class ProGen2MLP(nn.Module):
    def __init__(self, c: ProGen2Config):
        super().__init__()
        self.fc_in = Linear(c.embed_dim, 4 * c.embed_dim, c.dtype)
        self.fc_out = Linear(4 * c.embed_dim, c.embed_dim, c.dtype)
        self.act = TanhGelu()

    def forward(self, y):
        return self.fc_out(self.act(self.fc_in(y)))


class ProGen2Block(nn.Module):
    def __init__(self, c: ProGen2Config):
        super().__init__()
        self.ln_1 = LayerNorm(c.embed_dim)
        self.attn = ProGen2Attention(c)
        self.mlp = ProGen2MLP(c)

    def forward(self, x, cos, sin):
        y = self.ln_1(x)
        return self.attn(y, cos, sin) + self.mlp(y) + x  # parallel residual (ref :275)


class ProGen2Transformer(nn.Module):
    def __init__(self, c: ProGen2Config):
        super().__init__()
        self.wte = nn.Embedding(c.vocab_size, c.embed_dim, dtype=c.dtype)
        self.h = nn.ModuleList(ProGen2Block(c) for _ in range(c.num_layers))
        self.ln_f = LayerNorm(c.embed_dim)


class ProGen2(nn.Module):
    """(B, T) tokens -> (B, T, V) float32 logits."""

    def __init__(self, config: ProGen2Config):
        super().__init__()
        self.config = config
        self.transformer = ProGen2Transformer(config)
        self.lm_head = Linear(config.embed_dim, config.vocab_size, torch.float32)

    def forward(self, tokens):
        c, tr = self.config, self.transformer
        cos, sin = rope_tables(tokens.shape[1], c.rotary_dim, True, c.dtype, tokens.device)
        x = tr.wte(tokens)
        for block in tr.h:
            x = block(x, cos, sin)
        return self.lm_head(tr.ln_f(x).float())

    def restricted_logits(self, tokens):
        """Logits over the 25 amino-acid tokens for harness tokens 0..24 (ref
        compute_fitness.py:69-73 renormalises the cross-entropy over them)."""
        full = self(tokens + PROGEN2_AA_FIRST)
        return full[..., PROGEN2_AA_FIRST:PROGEN2_AA_LAST + 1]


def progen2_init(config: ProGen2Config, seed: int = 0, device="cuda") -> ProGen2:
    """Seeded random weights with the JAX ``progen2_init`` distribution."""
    return _init_normal(_empty(ProGen2, config, device), seed)


def progen2_load_state_dict(state_dict: Mapping, config: ProGen2Config,
                            device="cuda") -> ProGen2:
    """The model from a published ProGen2 state dict (``transformer.h.N.
    attn.qkv_proj.weight``, ...; the ``transformer.`` prefix optional)."""
    return copy_state_dict(_empty(ProGen2, config, device),
                           _prefixed(state_dict, "transformer."), config.name)


def progen2_params_from_jax(params, config: ProGen2Config) -> Dict[str, torch.Tensor]:
    """The JAX ``progen2_init`` pytree (numpy leaves) as a published state
    dict: (in, out) kernels become (out, in) ``Linear`` weights."""
    sd = {"transformer.wte.weight": _np32(params["wte"]),
          "transformer.ln_f.weight": _np32(params["ln_f"]["g"]),
          "transformer.ln_f.bias": _np32(params["ln_f"]["b"]),
          "lm_head.weight": _np32(np.asarray(params["lm_head"]["w"]).T),
          "lm_head.bias": _np32(params["lm_head"]["b"])}
    for i, layer in enumerate(params["layers"][:config.num_layers]):
        p = f"transformer.h.{i}"
        sd[f"{p}.ln_1.weight"] = _np32(layer["ln_1"]["g"])
        sd[f"{p}.ln_1.bias"] = _np32(layer["ln_1"]["b"])
        for name, key in (("qkv", "attn.qkv_proj"), ("out", "attn.out_proj"),
                          ("fc_in", "mlp.fc_in"), ("fc_out", "mlp.fc_out")):
            sd[f"{p}.{key}.weight"] = _np32(np.asarray(layer[name]["w"]).T)
            if "b" in layer[name]:
                sd[f"{p}.{key}.bias"] = _np32(layer[name]["b"])
    return sd

# ---------------------------------------------------------------------------
# RITA
# ---------------------------------------------------------------------------

# HF RITA tokenizer vocabulary (26): specials then the letters
RITA_TOKENS = ["<PAD>", "<EOS>"] + list("ACDEFGHIKLMNPQRSTVWYUXZB")


class RitaTokenizer:
    PAD = 0
    EOS = 1

    def __init__(self):
        self.tok_to_idx = {t: i for i, t in enumerate(RITA_TOKENS)}

    def encode(self, seq: str) -> np.ndarray:
        return np.asarray([self.tok_to_idx.get(c, self.tok_to_idx["X"]) for c in seq],
                          dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class RitaConfig:
    name: str = "RITA_s"
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    vocab_size: int = 26
    n_ctx: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


RITA_PRESETS = {
    "RITA_s": RitaConfig("RITA_s", 12, 768, 12, 3072),
    "RITA_m": RitaConfig("RITA_m", 24, 1024, 16, 4096),
    "RITA_l": RitaConfig("RITA_l", 24, 1536, 16, 6144),
    "RITA_xl": RitaConfig("RITA_xl", 24, 2048, 16, 8192),
}


class RitaAttention(nn.Module):
    def __init__(self, c: RitaConfig):
        super().__init__()
        self.c = c
        for name in ("query", "key", "value", "proj"):
            setattr(self, name, Linear(c.embed_dim, c.embed_dim, c.dtype))

    def forward(self, y, cos, sin):
        b, t, _ = y.shape
        heads = lambda z: z.view(b, t, self.c.num_heads, self.c.head_dim)
        q = apply_rope(heads(self.query(y)), cos, sin, False)
        k = apply_rope(heads(self.key(y)), cos, sin, False)
        return self.proj(causal_attend(q, k, heads(self.value(y))))


class RitaBlock(nn.Module):
    def __init__(self, c: RitaConfig):
        super().__init__()
        self.attn_norm = LayerNorm(c.embed_dim)
        self.self_attention = RitaAttention(c)
        self.mlp_norm = LayerNorm(c.embed_dim)
        self.mlp = nn.Sequential(Linear(c.embed_dim, c.ffn_dim, c.dtype), TanhGelu(),
                                 Linear(c.ffn_dim, c.embed_dim, c.dtype))

    def forward(self, x, cos, sin):
        x = x + self.self_attention(self.attn_norm(x), cos, sin)
        return x + self.mlp(self.mlp_norm(x))


class RitaTransformer(nn.Module):
    def __init__(self, c: RitaConfig):
        super().__init__()
        self.embedding = nn.Embedding(c.vocab_size, c.embed_dim, dtype=c.dtype)
        self.layers = nn.ModuleList(RitaBlock(c) for _ in range(c.num_layers))
        self.final_norm = LayerNorm(c.embed_dim)


class Rita(nn.Module):
    """(B, T) tokens -> (B, T, V) float32 logits."""

    def __init__(self, config: RitaConfig):
        super().__init__()
        self.config = config
        self.transformer = RitaTransformer(config)
        self.lm_head = Linear(config.embed_dim, config.vocab_size, torch.float32)

    def forward(self, tokens):
        c, tr = self.config, self.transformer
        cos, sin = rope_tables(tokens.shape[1], c.head_dim, False, c.dtype, tokens.device)
        x = tr.embedding(tokens)
        for block in tr.layers:
            x = block(x, cos, sin)
        return self.lm_head(tr.final_norm(x).float())


def rita_init(config: RitaConfig, seed: int = 0, device="cuda") -> Rita:
    """Seeded random weights with the JAX ``rita_init`` distribution."""
    return _init_normal(_empty(Rita, config, device), seed)


def rita_load_state_dict(state_dict: Mapping, config: RitaConfig, device="cuda") -> Rita:
    """The model from a published RITA state dict (``transformer.layers.N.
    self_attention.query.weight``, ``mlp.0``/``mlp.2``, ...; the prefix
    optional). The reference lm_head has no bias (rita_modeling.py:291):
    a missing one is zero, as in the JAX converter."""
    sd = _prefixed(state_dict, "transformer.")
    if "lm_head.bias" not in sd:
        sd["lm_head.bias"] = torch.zeros(config.vocab_size)
    return copy_state_dict(_empty(Rita, config, device), sd, config.name)


def rita_params_from_jax(params, config: RitaConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``rita_init`` pytree (numpy leaves) as a published state dict."""
    sd = {"transformer.embedding.weight": _np32(params["embedding"]),
          "transformer.final_norm.weight": _np32(params["final_norm"]["g"]),
          "transformer.final_norm.bias": _np32(params["final_norm"]["b"]),
          "lm_head.weight": _np32(np.asarray(params["lm_head"]["w"]).T),
          "lm_head.bias": _np32(params["lm_head"]["b"])}
    for i, layer in enumerate(params["layers"][:config.num_layers]):
        p = f"transformer.layers.{i}"
        for name in ("attn_norm", "mlp_norm"):
            sd[f"{p}.{name}.weight"] = _np32(layer[name]["g"])
            sd[f"{p}.{name}.bias"] = _np32(layer[name]["b"])
        for name, key in (("q", "self_attention.query"), ("k", "self_attention.key"),
                          ("v", "self_attention.value"), ("o", "self_attention.proj"),
                          ("fc1", "mlp.0"), ("fc2", "mlp.2")):
            sd[f"{p}.{key}.weight"] = _np32(np.asarray(layer[name]["w"]).T)
            sd[f"{p}.{key}.bias"] = _np32(layer[name]["b"])
    return sd

# ---------------------------------------------------------------------------
# ProtGPT2 / GPT-2
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Gpt2Config:
    name: str = "protgpt2"
    num_layers: int = 36
    embed_dim: int = 1280
    num_heads: int = 20
    vocab_size: int = 50257  # BPE over protein "words"
    n_ctx: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


class Gpt2Attention(nn.Module):
    def __init__(self, c: Gpt2Config):
        super().__init__()
        self.c = c
        self.c_attn = Conv1D(c.embed_dim, 3 * c.embed_dim, c.dtype)
        self.c_proj = Conv1D(c.embed_dim, c.embed_dim, c.dtype)

    def forward(self, y):
        b, t, _ = y.shape
        q, k, v = (z.view(b, t, self.c.num_heads, self.c.head_dim)
                   for z in self.c_attn(y).chunk(3, dim=-1))
        return self.c_proj(causal_attend(q, k, v))


class Gpt2MLP(nn.Module):
    def __init__(self, c: Gpt2Config):
        super().__init__()
        self.c_fc = Conv1D(c.embed_dim, 4 * c.embed_dim, c.dtype)
        self.c_proj = Conv1D(4 * c.embed_dim, c.embed_dim, c.dtype)
        self.act = TanhGelu()

    def forward(self, y):
        return self.c_proj(self.act(self.c_fc(y)))


class Gpt2Block(nn.Module):
    def __init__(self, c: Gpt2Config):
        super().__init__()
        self.ln_1 = LayerNorm(c.embed_dim)
        self.attn = Gpt2Attention(c)
        self.ln_2 = LayerNorm(c.embed_dim)
        self.mlp = Gpt2MLP(c)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Gpt2Transformer(nn.Module):
    def __init__(self, c: Gpt2Config):
        super().__init__()
        self.wte = nn.Embedding(c.vocab_size, c.embed_dim, dtype=c.dtype)
        self.wpe = nn.Embedding(c.n_ctx, c.embed_dim, dtype=c.dtype)
        self.h = nn.ModuleList(Gpt2Block(c) for _ in range(c.num_layers))
        self.ln_f = LayerNorm(c.embed_dim)


class Gpt2(nn.Module):
    """(B, T) tokens -> (B, T, V) float32 logits from the head tied to the
    token embedding (model dtype x model dtype, float32 output)."""

    def __init__(self, config: Gpt2Config):
        super().__init__()
        self.config = config
        self.transformer = Gpt2Transformer(config)

    def forward(self, tokens):
        tr = self.transformer
        x = tr.wte(tokens) + tr.wpe.weight[:tokens.shape[1]]
        for block in tr.h:
            x = block(x)
        return matmul_f32(tr.ln_f(x), tr.wte.weight.t())


def gpt2_init(config: Gpt2Config, seed: int = 0, device="cuda") -> Gpt2:
    """Seeded random weights with the JAX ``gpt2_init`` distribution (wpe
    N(0, 0.01^2))."""
    return _init_normal(_empty(Gpt2, config, device), seed,
                        scales={"transformer.wpe.weight": 0.01})


def gpt2_load_state_dict(state_dict: Mapping, config: Gpt2Config, device="cuda") -> Gpt2:
    """The model from an HF GPT-2 state dict (``transformer.h.N.attn.c_attn``,
    Conv1D weights (in, out), kept as they are; the prefix optional; the
    tied ``lm_head.weight`` and attention-mask buffers ignored)."""
    return copy_state_dict(_empty(Gpt2, config, device),
                           _prefixed(state_dict, "transformer."), config.name)


def gpt2_params_from_jax(params, config: Gpt2Config) -> Dict[str, torch.Tensor]:
    """The JAX ``gpt2_init`` pytree (numpy leaves) as an HF state dict:
    its (in, out) kernels are already GPT-2's Conv1D layout."""
    sd = {"transformer.wte.weight": _np32(params["wte"]),
          "transformer.wpe.weight": _np32(params["wpe"]),
          "transformer.ln_f.weight": _np32(params["ln_f"]["g"]),
          "transformer.ln_f.bias": _np32(params["ln_f"]["b"])}
    for i, layer in enumerate(params["layers"][:config.num_layers]):
        p = f"transformer.h.{i}"
        for name in ("ln_1", "ln_2"):
            sd[f"{p}.{name}.weight"] = _np32(layer[name]["g"])
            sd[f"{p}.{name}.bias"] = _np32(layer[name]["b"])
        for name, key in (("c_attn", "attn.c_attn"), ("c_proj", "attn.c_proj"),
                          ("c_fc", "mlp.c_fc"), ("c_proj_mlp", "mlp.c_proj")):
            sd[f"{p}.{key}.weight"] = _np32(layer[name]["w"])
            sd[f"{p}.{key}.bias"] = _np32(layer[name]["b"])
    return sd
