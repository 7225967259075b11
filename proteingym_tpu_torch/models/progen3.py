"""ProGen3: a mixture-of-experts causal protein LM, as a PyTorch module
(counterpart of proteingym_tpu/models/progen3.py; ref
proteingym/baselines/progen3/progen3/modeling.py, model/attention.py,
model/moe.py, config.py):

- token embedding plus a sequence-id embedding (plain scoring uses id 0);
- RMSNorm pre-norm blocks (``input_layernorm``, ``post_attention_layernorm``);
- attention: bias-free q/k/v/o projections in float32, grouped-query heads
  (``num_key_value_heads``, repeated), llama ``rotate_half`` rotary over the
  whole head with theta 1e5, indexed by position ids;
- the MoE block: the router's float32 softmax, top-k, renormalised
  (``router_weights``), experts w2(silu(w1 x)) or, gated, w2(silu(w1 x) *
  w3 x), in float32 (``moe_ffn``);
- an untied float32 lm_head.

The expert route is this card's, not the TPU's: the JAX single-chip route
runs every expert on every token and weights the outputs by the mostly
zero routing weights (static shapes for the MXU). Here each expert runs
only on the tokens routed to it: gather, float32 matmul, scatter-add with
the routing weight. The function is the same, with num_experts / top_k
fewer expert FLOPs (4x at top-2 of 8). The float32 products (projections,
experts, lm_head) run in full float32: torch's default for a float32
``matmul`` is TF32 off, and the scorer runs inside ``devices.no_tf32()``.

The expert-parallel forward (``shard_experts`` / ``expert_sharded_apply``)
keeps E / n experts (w1/w2/w3) on each rank of a process group of n, the
router and everything else replicated; each rank runs its experts, routed,
on the tokens that chose them, and one all-reduce per layer sums the
ranks' expert outputs. It equals the unsharded forward up to the order of
the float32 sums.

Embeddings are stored in the model dtype (the cast the JAX model makes at
every use, made once); norms, projections, experts and the head in
float32, as the JAX model uses them. Parameter names are the reference's
(``model.layers.N.self_attn.q_proj``, ``block_sparse_moe.experts.E.w1``);
``convert_torch_state_dict`` also reads its fused ``norm_attn_norm``
layout.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.ops.flash_attention import mha

# ---------------------------------------------------------------------------
# Tokenizer (ref progen3/tokenizer.json)
# ---------------------------------------------------------------------------

PROGEN3_SPECIALS = ["<pad>", "<bos>", "<eos>", "<bos_glm>", "<eos_span>", "<mask>"]
PROGEN3_TOKENS = PROGEN3_SPECIALS + ["1", "2"] + list("ABCDEFGHIJKLMNOPQRSTUVWXYZ")
PAD, BOS, EOS = 0, 1, 2
TERM_N, TERM_C = 6, 7  # "1" and "2"
AA_OFFSET = 8  # the first letter's id: the harness's tokens 0..25 are A..Z


class ProGen3Tokenizer:
    def __init__(self):
        self.tok_to_idx = {t: i for i, t in enumerate(PROGEN3_TOKENS)}

    def encode_clm(self, seq: str, reverse: bool = False) -> np.ndarray:
        """<bos> 1 SEQ 2 <eos> (ref batch_preparer.py:100-114); the reversed
        pass reverses the terminal-wrapped string, not the token list."""
        s = "1" + seq + "2"
        if reverse:
            s = s[::-1]
        ids = [BOS] + [self.tok_to_idx[c] for c in s if c in self.tok_to_idx] + [EOS]
        return np.asarray(ids, dtype=np.int64)


TOKENIZER = ProGen3Tokenizer()


@dataclasses.dataclass(frozen=True)
class ProGen3Config:
    name: str = "progen3-112m"
    num_layers: int = 12
    hidden_dim: int = 768
    num_heads: int = 12
    num_kv_heads: Optional[int] = None  # None: num_heads (no GQA)
    ffn_dim: int = 2048  # per expert
    num_experts: int = 8
    top_k: int = 2
    gated_mlp: bool = False
    vocab_size: int = 34
    max_num_seqs: int = 512
    rope_theta: float = 100_000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads


PRESETS = {
    "progen3-112m": ProGen3Config("progen3-112m", 12, 768, 12, None, 2048),
    "progen3-339m": ProGen3Config("progen3-339m", 16, 1024, 16, None, 2816),
    "progen3-1b": ProGen3Config("progen3-1b", 24, 1536, 16, None, 4096),
    "progen3-3b": ProGen3Config("progen3-3b", 28, 2304, 24, None, 5760),
}


# ---------------------------------------------------------------------------
# Pieces
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * g in float32, returned in x's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dim))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.weight).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """llama rotate_half rotary over the whole head, x (B, T, H, hd) in the
    model dtype, positions (B, T); the angles in float32 and the tables cast
    to x's dtype, as the JAX ``_rope``."""
    hd = x.shape[-1]
    inv_freq = theta ** -(torch.arange(0, hd, 2, dtype=torch.float32, device=x.device) / hd)
    angles = positions[..., None].float() * inv_freq
    emb = torch.cat([angles, angles], dim=-1)[:, :, None, :]
    cos, sin = emb.cos().to(x.dtype), emb.sin().to(x.dtype)
    half = hd // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos + rot * sin


def router_weights(x32: torch.Tensor, router: torch.Tensor, num_experts: int, top_k: int):
    """(..., D) float32 tokens, (D, E) router -> (..., E) routing weights:
    softmax in float32, the top-k kept and renormalised, the rest 0 (ref
    moe.py:90-104)."""
    probs = torch.softmax((x32 @ router).float(), dim=-1)
    # a stable sort: among equal probabilities the lower expert index wins,
    # as in lax.top_k (a zero router gives all experts equal weight)
    top_vals, top_idx = (z[..., :top_k] for z in probs.sort(dim=-1, descending=True,
                                                             stable=True))
    top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
    return torch.zeros_like(probs).scatter_(-1, top_idx, top_vals)


class Expert(nn.Module):
    def __init__(self, c: ProGen3Config):
        super().__init__()
        self.w1 = nn.Linear(c.hidden_dim, c.ffn_dim, bias=False)
        self.w2 = nn.Linear(c.ffn_dim, c.hidden_dim, bias=False)
        self.w3 = nn.Linear(c.hidden_dim, c.ffn_dim, bias=False) if c.gated_mlp else None

    def forward(self, x32):
        h = F.silu(self.w1(x32))
        if self.w3 is not None:
            h = h * self.w3(x32)
        return self.w2(h)


class SparseMoeBlock(nn.Module):
    def __init__(self, c: ProGen3Config):
        super().__init__()
        self.c = c
        self.gate = nn.Linear(c.hidden_dim, c.num_experts, bias=False)
        self.experts = nn.ModuleList(Expert(c) for _ in range(c.num_experts))
        # expert parallelism (shard_experts): the index of experts[0] among
        # all E, and the group whose ranks hold the other experts
        self.first_expert, self.group = 0, None

    def forward(self, x):
        return moe_ffn(x, self)


def moe_ffn(x: torch.Tensor, moe: SparseMoeBlock) -> torch.Tensor:
    """The token-dropless MoE on (B, T, D) x, routed: each expert runs in
    float32 on the tokens whose top-k holds it, and its outputs, times their
    routing weights, are added into the float32 result; cast to x's dtype.
    The JAX dense route's function, with num_experts / top_k fewer FLOPs.
    Under ``shard_experts`` the block holds this rank's experts only and
    the ranks' results are summed over its group (the JAX ``psum``)."""
    c = moe.c
    xe = x.float().reshape(-1, x.shape[-1])
    weights = router_weights(xe, moe.gate.weight.t(), c.num_experts, c.top_k)  # (N, E)
    out = torch.zeros_like(xe)
    for e, expert in enumerate(moe.experts, start=moe.first_expert):
        # a routed weight of 0 (an underflowed probability) adds nothing either way
        idx = (weights[:, e] > 0).nonzero().squeeze(1)
        if idx.numel():
            out.index_add_(0, idx, expert(xe[idx]) * weights[idx, e, None])
    if moe.group is not None:
        dist.all_reduce(out, group=moe.group)
    return out.view(x.shape).to(x.dtype)


class Attention(nn.Module):
    def __init__(self, c: ProGen3Config):
        super().__init__()
        self.c = c
        hd = c.head_dim
        self.q_proj = nn.Linear(c.hidden_dim, c.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(c.hidden_dim, c.kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(c.hidden_dim, c.kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(c.num_heads * hd, c.hidden_dim, bias=False)

    def forward(self, y, positions):
        c = self.c
        b, t, _ = y.shape
        y32 = y.float()
        heads = lambda z, n: z.view(b, t, n, c.head_dim).to(c.dtype)
        q = rope(heads(self.q_proj(y32), c.num_heads), positions, c.rope_theta)
        k = rope(heads(self.k_proj(y32), c.kv_heads), positions, c.rope_theta)
        v = heads(self.v_proj(y32), c.kv_heads)
        if c.kv_heads != c.num_heads:  # GQA: repeat kv heads (ref attention.py:15-25)
            rep = c.num_heads // c.kv_heads
            k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
        tr = lambda z: z.float().transpose(1, 2)
        ctx = mha(tr(q), tr(k), tr(v), causal=True).transpose(1, 2).reshape(b, t, -1)
        return self.o_proj(ctx).to(c.dtype)


class DecoderLayer(nn.Module):
    def __init__(self, c: ProGen3Config):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_dim, c.rms_eps)
        self.self_attn = Attention(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_dim, c.rms_eps)
        self.block_sparse_moe = SparseMoeBlock(c)

    def forward(self, x, positions):
        x = x + self.self_attn(self.input_layernorm(x), positions)
        return x + self.block_sparse_moe(self.post_attention_layernorm(x))


class ProGen3Model(nn.Module):
    def __init__(self, c: ProGen3Config):
        super().__init__()
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_dim, dtype=c.dtype)
        self.embed_seq_id = nn.Embedding(c.max_num_seqs, c.hidden_dim, dtype=c.dtype)
        self.layers = nn.ModuleList(DecoderLayer(c) for _ in range(c.num_layers))
        self.norm = RMSNorm(c.hidden_dim, c.rms_eps)


class ProGen3(nn.Module):
    """(B, T) tokens -> (B, T, V) float32 logits: the JAX ``apply``."""

    def __init__(self, config: ProGen3Config):
        super().__init__()
        self.config = config
        self.model = ProGen3Model(config)
        self.lm_head = nn.Linear(config.hidden_dim, config.vocab_size, bias=False)

    def forward(self, tokens, position_ids=None, sequence_ids=None):
        b, t = tokens.shape
        if position_ids is None:
            position_ids = torch.arange(t, device=tokens.device).expand(b, t)
        if sequence_ids is None:
            sequence_ids = torch.zeros_like(tokens)
        m = self.model
        x = m.embed_tokens(tokens) + m.embed_seq_id(sequence_ids)
        for layer in m.layers:
            x = layer(x, position_ids)
        return self.lm_head(m.norm(x).float())

    def restricted_logits(self, tokens):
        """Logits over the 26 letters for harness tokens 0..25 (A..Z): the
        JAX ``restricted_apply_fn``."""
        return self(tokens + AA_OFFSET)[..., AA_OFFSET:AA_OFFSET + 26]


def shard_experts(model: ProGen3, group=None) -> ProGen3:
    """Keep this rank's E / n experts of every layer (n the size of
    ``group``, default the whole world; rank r holds experts r E / n ..
    (r + 1) E / n - 1) and drop the rest, in place; the forward then sums
    each layer's expert outputs over ``group``. Every rank of the group
    must run the same forwards."""
    group = group or dist.group.WORLD
    n, r = dist.get_world_size(group), dist.get_rank(group)
    e = model.config.num_experts
    if e % n:
        raise ValueError(f"{e} experts do not divide over a group of {n}")
    for layer in model.model.layers:
        moe = layer.block_sparse_moe
        if moe.group is not None:
            raise ValueError("the experts are sharded already")
        local = e // n
        moe.experts = nn.ModuleList(list(moe.experts)[r * local:(r + 1) * local])
        moe.first_expert, moe.group = r * local, group
    return model


def expert_sharded_apply(model: ProGen3, tokens: torch.Tensor, group=None) -> torch.Tensor:
    """The forward with the experts sharded over ``group`` (counterpart of
    the JAX ``expert_sharded_apply``, whose experts are sharded over a mesh
    axis): shards ``model`` in place on first use (``shard_experts``), then
    returns the (B, T, V) float32 logits, the same on every rank."""
    if model.model.layers[0].block_sparse_moe.group is None:
        shard_experts(model, group)
    return model(tokens)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _empty(config: ProGen3Config, device) -> ProGen3:
    with torch.device("meta"):
        model = ProGen3(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: ProGen3Config, seed: int = 0, device="cuda") -> ProGen3:
    """Seeded random weights with the JAX ``init_params`` distribution (the
    draws differ): every matrix N(0, 0.02^2), unit norm scales."""
    model = _empty(config, device)
    dev = model.lm_head.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if isinstance(model.get_submodule(name.rsplit(".", 1)[0]), RMSNorm):
            p.fill_(1.0)
        else:
            for chunk in p.view(-1, p.shape[-1]).split(4096):
                chunk.copy_(torch.randn(tuple(chunk.shape), generator=gen, device=dev) * 0.02)
    return model


def convert_torch_state_dict(state_dict: Mapping, config: ProGen3Config,
                             device="cuda") -> ProGen3:
    """The model from a reference ProGen3 state dict: the flat layout
    (``model.layers.N.self_attn.q_proj.weight``) or the fused one
    (``model.layers.N.norm_attn_norm.self_attn...``), with or without the
    ``model.`` prefix. A layer without a router gets zeros, as in the JAX
    converter."""
    sd = {}
    for key, value in state_dict.items():
        if not key.startswith(("model.", "lm_head.")):
            key = "model." + key
        sd[key.replace(".norm_attn_norm.", ".")] = value
    for i in range(config.num_layers):
        sd.setdefault(f"model.layers.{i}.block_sparse_moe.gate.weight",
                      torch.zeros(config.num_experts, config.hidden_dim))
    return copy_state_dict(_empty(config, device), sd, config.name)


def params_from_jax(params, config: ProGen3Config) -> Dict[str, torch.Tensor]:
    """The JAX ``init_params`` pytree (numpy leaves) as a reference state
    dict: (in, out) matrices become (out, in) ``Linear`` weights and the
    stacked (E, ...) expert tensors one Linear per expert."""
    t = lambda a: torch.from_numpy(np.array(np.asarray(a, dtype=np.float32).T))
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    sd = {"model.embed_tokens.weight": a(params["embed_tokens"]),
          "model.embed_seq_id.weight": a(params["embed_seq_id"]),
          "model.norm.weight": a(params["final_norm"]), "lm_head.weight": t(params["lm_head"])}
    for i, layer in enumerate(params["layers"][:config.num_layers]):
        p = f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = a(layer["input_norm"])
        sd[f"{p}.post_attention_layernorm.weight"] = a(layer["post_attn_norm"])
        for name in ("q", "k", "v", "o"):
            sd[f"{p}.self_attn.{name}_proj.weight"] = t(layer[name])
        sd[f"{p}.block_sparse_moe.gate.weight"] = t(layer["router"])
        for w in ("w1", "w2", "w3"):
            if w in layer:
                for e in range(config.num_experts):
                    sd[f"{p}.block_sparse_moe.experts.{e}.{w}.weight"] = t(layer[w][e])
    return sd


def config_from_hf_json(path, name: str = "progen3") -> ProGen3Config:
    """A config from an HF checkpoint's config.json (the vendored
    configuration class's field names, ref progen3/config.py:28-75):
    the published sizes without a preset here (219m, 762m, ...)."""
    meta = json.loads(open(path).read())
    hidden = int(meta["hidden_size"])
    inter = meta.get("intermediate_size")
    gated = bool(meta.get("gated_mlp", False))
    if inter is None:
        inter = 3 * hidden if gated else 4 * hidden
    return ProGen3Config(
        name=meta.get("_name_or_path", name) or name,
        num_layers=int(meta["num_hidden_layers"]),
        hidden_dim=hidden,
        num_heads=int(meta["num_attention_heads"]),
        num_kv_heads=(int(meta["num_key_value_heads"])
                      if meta.get("num_key_value_heads") is not None else None),
        ffn_dim=int(inter),
        num_experts=int(meta.get("num_experts", 8)),
        top_k=int(meta.get("num_experts_per_tok", 2)),
        gated_mlp=gated,
        vocab_size=int(meta.get("vocab_size") or 34),
        max_num_seqs=int(meta.get("max_num_sequences", 512)),
        rope_theta=float(meta.get("rope_theta", 100_000.0)),
        rms_eps=float(meta.get("rms_norm_eps", 1e-5)),
    )

# ---------------------------------------------------------------------------
# Scoring (ref scorer.py:67-80, batch_preparer.py:100-114)
# ---------------------------------------------------------------------------


@torch.no_grad()
def score_sequences(model: ProGen3, sequences: Sequence[str], batch_size: int = 16) -> np.ndarray:
    """Mirrored mean log-likelihood of each sequence, float64 (N,): the
    mean over its shifted targets of each direction's <bos> 1 SEQ 2 <eos>
    row, averaged over the two directions."""
    dev = model.lm_head.weight.device
    out = np.zeros(len(sequences))
    for rev in (False, True):
        rows = [TOKENIZER.encode_clm(s, reverse=rev) for s in sequences]
        for s in range(0, len(rows), batch_size):
            blk = rows[s:s + batch_size]
            toks = np.full((len(blk), max(len(r) for r in blk)), PAD, np.int64)
            for i, r in enumerate(blk):
                toks[i, :len(r)] = r
            tokens = torch.from_numpy(toks).to(dev)
            logp = torch.log_softmax(model(tokens), dim=-1)
            tgt = tokens[:, 1:]
            ll = logp[:, :-1].gather(-1, tgt[..., None])[..., 0]
            mask = (tgt != PAD).float()
            lls = (ll * mask).sum(-1) / mask.sum(-1).clamp(min=1)
            out[s:s + len(blk)] += lls.double().cpu().numpy()
    return out / 2.0
