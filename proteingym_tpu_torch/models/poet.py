"""PoET: tiered autoregressive transformer over sequences-of-sequences, as a
PyTorch module (counterpart of proteingym_tpu/models/poet.py).

  input  [$ seq1 * $ seq2 * ... $ query *]   (one flattened token row)
  each layer (pre-LN):
    x += self_attn(norm1(x))        within-segment causal attention; RoPE at
                                    global row positions inside the kernel,
                                    equivalent to per-segment positions
                                    because cross-segment pairs are masked
    x += multihead_attn(norm2(x))   causal attention over the whole row, q/k
                                    pre-rotated by the per-segment positions
    x += linear2(gelu_tanh(linear1(norm3(x))))
  final LayerNorm (when present) -> untied float32 vocab head.

Semantics match the JAX ``apply``: dense layers use weights in the
activation dtype with float32 accumulation (their biases are held in that
dtype too; JAX adds a float32 bias before rounding), LN runs in float32
(eps 1e-5),
the FFN's GELU is the tanh approximation on float32 (``jax.nn.gelu``'s
default), and the head runs in float32 on float32 activations. The
multi-tier cos/sin are computed in float32 and rounded to the activation
dtype before the rotation, as in the JAX package.

Attention goes through ``ops.flash_attention.mha``: the self tier is
segmented + causal + RoPE (the grouped kernel at every T), the multi tier is
causal + key mask (the grouped kernel up to T = 1024, the long-context
kernel beyond).

Module names follow the published PoET state dict (token_embed,
decoder.layers.N.{self_attn, multihead_attn, linear1, linear2, norm1-3},
norm, linear); ``load_state_dict_poet`` reads it, with fused or separate
q/k/v projections. Context sampling and row building are numpy, as in the
JAX package, so both pick identical contexts from identical weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.models.esm2 import LayerNorm
from proteingym_tpu_torch.ops.flash_attention import mha
from proteingym_tpu_torch.ops.rotary import rotate_half

POET_CHARS = "ARNDCQEGHILKMFPSTWYV"
GAP, START, STOP, MASK_X = 20, 21, 22, 23
_SYNONYM = {"O": 11, "U": 4}  # O->K, U->C; B/Z fall through to mask
ROPE_BASE = 10000.0


class PoetAlphabet:
    """'ARNDCQEGHILKMFPSTWYV' (0-19), '-' = 20, start '$' = 21, stop '*' =
    22, X/mask/padding = 23; O/U map to K/C, B/Z to the mask."""

    n_vocab = 24
    start_token = START
    stop_token = STOP
    pad = MASK_X

    def __init__(self):
        self.aa_to_idx = {c: i for i, c in enumerate(POET_CHARS)}

    def encode(self, seq: str) -> np.ndarray:
        out = []
        for ch in seq.upper():
            if ch in self.aa_to_idx:
                out.append(self.aa_to_idx[ch])
            elif ch == "-":
                out.append(GAP)
            else:
                out.append(_SYNONYM.get(ch, MASK_X))
        return np.asarray(out, dtype=np.int32)


ALPHABET = PoetAlphabet()


@dataclasses.dataclass(frozen=True)
class PoetConfig:
    name: str = "poet_200m"
    num_layers: int = 12
    hidden_dim: int = 1024
    num_heads: int = 16
    ffn_dim: int = 4096
    n_vocab: int = 24
    final_norm: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads


POET_PRESETS: Dict[str, PoetConfig] = {
    # float32 tiny config for CPU tests (the JAX preset of the same shape
    # runs in bf16)
    "poet_tiny": PoetConfig("poet_tiny", 2, 64, 4, 128, dtype=torch.float32),
    "poet_200m": PoetConfig("poet_200m", 12, 1024, 16, 4096),
}


class PoetAttention(nn.Module):
    def __init__(self, config: PoetConfig, device=None):
        super().__init__()
        d, kw = config.hidden_dim, dict(device=device, dtype=config.dtype)
        self.num_heads, self.head_dim = config.num_heads, config.head_dim
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)

    def forward(self, x, segment_ids=None, key_mask=None, rope=None):
        """``segment_ids`` (B, T), 0 = padding: the self tier. Otherwise
        ``key_mask`` (B, T) and ``rope`` = (cos, sin), each (B, T, 1, hd) in
        x's dtype: the multi tier."""
        b, t, d = x.shape
        q, k, v = (p(x).view(b, t, self.num_heads, self.head_dim)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        if segment_ids is None:
            cos, sin = rope
            q = q * cos + rotate_half(q) * sin
            k = k * cos + rotate_half(k) * sin

        def tr(z):  # (B, T, H, hd) <-> (B, H, T, hd) views
            return z.permute(0, 2, 1, 3)

        if segment_ids is not None:
            ctx = mha(tr(q), tr(k), tr(v), causal=True,
                      segment_ids=segment_ids, rope_base=ROPE_BASE)
        else:
            ctx = mha(tr(q), tr(k), tr(v), causal=True, key_mask=key_mask)
        return self.out_proj(tr(ctx).reshape(b, t, d).to(x.dtype))


class PoetLayer(nn.Module):
    def __init__(self, config: PoetConfig, device=None):
        super().__init__()
        d, kw = config.hidden_dim, dict(device=device, dtype=config.dtype)
        self.norm1 = LayerNorm(d, device=device)
        self.norm2 = LayerNorm(d, device=device)
        self.norm3 = LayerNorm(d, device=device)
        self.self_attn = PoetAttention(config, device)
        self.multihead_attn = PoetAttention(config, device)
        self.linear1 = nn.Linear(d, config.ffn_dim, **kw)
        self.linear2 = nn.Linear(config.ffn_dim, d, **kw)

    def forward(self, x, segment_ids, valid, rope):
        x = x + self.self_attn(self.norm1(x), segment_ids=segment_ids)
        x = x + self.multihead_attn(self.norm2(x), key_mask=valid, rope=rope)
        y = F.gelu(self.linear1(self.norm3(x)).float(), approximate="tanh")
        return x + self.linear2(y.to(x.dtype))


class _Decoder(nn.Module):
    def __init__(self, config: PoetConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(PoetLayer(config, device) for _ in range(config.num_layers))


def _rope_by_positions(positions: torch.Tensor, head_dim: int, dtype: torch.dtype):
    """(B, T) per-segment positions -> cos, sin (B, T, 1, hd): float32
    angles, rounded to ``dtype`` (JAX ``_rope_by_positions``)."""
    inv = 1.0 / (ROPE_BASE ** (np.arange(0, head_dim, 2) / head_dim))
    inv = torch.from_numpy(inv.astype(np.float32)).to(positions.device)
    freqs = positions[..., None].to(torch.float32) * inv
    emb = torch.cat([freqs, freqs], dim=-1)[:, :, None, :]
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


class PoetModel(nn.Module):
    """tokens/segment_ids/positions/valid (B, T) -> (B, T, V) float32 logits."""

    def __init__(self, config: PoetConfig, device=None):
        super().__init__()
        self.config = config
        d = config.hidden_dim
        self.token_embed = nn.Embedding(config.n_vocab, d, device=device, dtype=config.dtype)
        self.decoder = _Decoder(config, device)
        self.norm = LayerNorm(d, device=device) if config.final_norm else None
        self.linear = nn.Linear(d, config.n_vocab, device=device)  # float32 head

    def forward(self, tokens, segment_ids, positions, valid):
        x = self.token_embed(tokens.long())
        # self layers: block-diagonal per-segment causal; 0 marks padding
        # (build_rows numbers segments from 0, so shift by one)
        seg_nonzero = (segment_ids.to(torch.int32) + 1) * valid.to(torch.int32)
        rope = _rope_by_positions(positions, self.config.head_dim, x.dtype)
        valid = valid.to(torch.bool)
        for layer in self.decoder.layers:
            x = layer(x, seg_nonzero, valid, rope)
        if self.norm is not None:
            x = self.norm(x)
        return self.linear(x.float())


def _empty_model(config: PoetConfig, device) -> PoetModel:
    with torch.device("meta"):
        model = PoetModel(config)
    return model.to_empty(device=torch.device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: PoetConfig, seed: int = 0, device="cpu") -> PoetModel:
    """Seeded random init with the JAX ``init_params`` distribution (the
    draws differ): dense weights and the embedding N(0, 0.02^2), zero
    biases, unit LN scales, and ``linear2`` zero (as the reference
    initialises it, so a random model's FFN adds nothing)."""
    model = _empty_model(config, device)
    gen = torch.Generator(device=model.token_embed.weight.device).manual_seed(seed)

    def normal(p):
        p.copy_(torch.randn(tuple(p.shape), generator=gen, device=p.device,
                            dtype=torch.float32) * 0.02)

    for name, module in model.named_modules():
        if isinstance(module, nn.Linear):
            if name.endswith("linear2"):
                module.weight.zero_()
            else:
                normal(module.weight)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            normal(module.weight)
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# Weight bridges
# ---------------------------------------------------------------------------

@torch.no_grad()
def load_state_dict_poet(model: PoetModel, state_dict: Mapping) -> PoetModel:
    """Fill ``model`` from a PoET state dict (the key layout the JAX
    ``convert_torch_state_dict`` reads; tensors or numpy arrays). Attention
    may come as a fused ``in_proj_weight``/``in_proj_bias`` or as separate
    ``q_proj``/``k_proj``/``v_proj``; an absent bias is zero; without
    ``norm.weight`` the final LayerNorm is dropped, as in the JAX
    converter. A key the model needs and does not find raises."""

    def get(key) -> torch.Tensor:
        if key not in state_dict:
            raise KeyError(f"PoET checkpoint lacks {key!r}")
        v = state_dict[key]
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.array(v, dtype=np.float32))
        return v.detach().to(torch.float32)

    def put(param, value, key):
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, "
                             f"model shape {tuple(param.shape)}")
        param.copy_(value.to(param.device))

    def dense(module, prefix, weight=None, bias=None):
        put(module.weight, get(f"{prefix}.weight") if weight is None else weight,
            f"{prefix}.weight")
        if bias is None:
            key = f"{prefix}.bias"
            bias = get(key) if key in state_dict else torch.zeros(module.bias.shape)
        put(module.bias, bias, f"{prefix}.bias")

    def ln(module, prefix):
        put(module.weight, get(f"{prefix}.weight"), f"{prefix}.weight")
        put(module.bias, get(f"{prefix}.bias"), f"{prefix}.bias")

    def attn(module, prefix):
        if f"{prefix}.in_proj_weight" in state_dict:
            w = get(f"{prefix}.in_proj_weight")
            key = f"{prefix}.in_proj_bias"
            b = get(key) if key in state_dict else torch.zeros(w.shape[0])
            for proj, pw, pb in zip(("q_proj", "k_proj", "v_proj"), w.chunk(3, 0), b.chunk(3)):
                dense(getattr(module, proj), f"{prefix}.in_proj[{proj}]", pw, pb)
        else:
            for proj in ("q_proj", "k_proj", "v_proj"):
                dense(getattr(module, proj), f"{prefix}.{proj}")
        dense(module.out_proj, f"{prefix}.out_proj")

    put(model.token_embed.weight, get("token_embed.weight"), "token_embed.weight")
    for i, layer in enumerate(model.decoder.layers):
        lp = f"decoder.layers.{i}"
        for n in ("norm1", "norm2", "norm3"):
            ln(getattr(layer, n), f"{lp}.{n}")
        attn(layer.self_attn, f"{lp}.self_attn")
        attn(layer.multihead_attn, f"{lp}.multihead_attn")
        dense(layer.linear1, f"{lp}.linear1")
        dense(layer.linear2, f"{lp}.linear2")
    if "norm.weight" in state_dict:
        if model.norm is None:
            model.norm = LayerNorm(model.config.hidden_dim,
                                   device=model.token_embed.weight.device).requires_grad_(False)
        ln(model.norm, "norm")
    else:
        model.norm = None
    dense(model.linear, "linear")
    return model


def _params_to_state_dict(params) -> Dict[str, np.ndarray]:
    """The JAX params pytree (numpy leaves) as a PoET state dict with
    separate q/k/v projections. JAX dense kernels are (in, out); PoET's
    Linear weights are (out, in)."""
    sd: Dict[str, np.ndarray] = {}

    def dense(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["w"], np.float32).T
        sd[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)

    def ln(prefix, p):
        sd[f"{prefix}.weight"] = np.asarray(p["g"], np.float32)
        sd[f"{prefix}.bias"] = np.asarray(p["b"], np.float32)

    sd["token_embed.weight"] = np.asarray(params["token_embed"], np.float32)
    for i, layer in enumerate(params["layers"]):
        lp = f"decoder.layers.{i}"
        for n in ("norm1", "norm2", "norm3"):
            ln(f"{lp}.{n}", layer[n])
        for tier, name in (("self", "self_attn"), ("multi", "multihead_attn")):
            for proj in "qkv":
                dense(f"{lp}.{name}.{proj}_proj", layer[tier][proj])
            dense(f"{lp}.{name}.out_proj", layer[tier]["o"])
        dense(f"{lp}.linear1", layer["fc1"])
        dense(f"{lp}.linear2", layer["fc2"])
    if params.get("final_norm") is not None:
        ln("norm", params["final_norm"])
    dense("linear", params["head"])
    return sd


def from_jax_params(params, config: PoetConfig, device="cpu") -> PoetModel:
    """The port's model from the JAX params pytree (numpy leaves)."""
    return load_state_dict_poet(_empty_model(config, device), _params_to_state_dict(params))


# ---------------------------------------------------------------------------
# Context building + scoring
# ---------------------------------------------------------------------------

def sample_context(
    sequences: Sequence[str],
    weights: Optional[np.ndarray],
    max_tokens: int,
    seed: int,
) -> List[str]:
    """Weight-proportional family sampling into a token budget (the
    reference's NeighborsSampler role). Gaps are stripped (PoET consumes
    unaligned sequences). The same numpy draws as the JAX package."""
    rng = np.random.default_rng(seed)
    seqs = [s.replace("-", "").replace(".", "").upper() for s in sequences]
    if weights is None:
        weights = np.ones(len(seqs))
    p = np.asarray(weights, np.float64)
    p = p / p.sum()
    order = rng.choice(len(seqs), size=len(seqs), replace=False, p=p)
    picked, used = [], 0
    for i in order:
        need = len(seqs[i]) + 2
        if used + need > max_tokens:
            continue
        picked.append(seqs[i])
        used += need
    return picked


def build_rows(
    context: Sequence[str], queries: Sequence[str]
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One row per query: [start ctx1 stop | start ctx2 stop | ... |
    start query stop]. Returns (tokens, segment_ids, positions, valid,
    query_token_mask) padded to a common length."""
    ctx_toks, ctx_segs, ctx_pos = [], [], []
    for si, seq in enumerate(context):
        seg = np.concatenate([[START], ALPHABET.encode(seq), [STOP]])
        ctx_toks.append(seg)
        ctx_segs.append(np.full(len(seg), si, np.int32))
        ctx_pos.append(np.arange(len(seg), dtype=np.int32))
    empty = np.zeros(0, np.int32)
    base_toks = np.concatenate(ctx_toks) if ctx_toks else empty
    base_segs = np.concatenate(ctx_segs) if ctx_segs else empty
    base_pos = np.concatenate(ctx_pos) if ctx_pos else empty

    rows, segs, poss, qmasks = [], [], [], []
    qseg = len(context)
    for q in queries:
        seg = np.concatenate([[START], ALPHABET.encode(q.replace("-", "")), [STOP]])
        rows.append(np.concatenate([base_toks, seg]).astype(np.int32))
        segs.append(np.concatenate([base_segs, np.full(len(seg), qseg, np.int32)]))
        poss.append(np.concatenate([base_pos, np.arange(len(seg), dtype=np.int32)]))
        qm = np.zeros(len(rows[-1]), bool)
        qm[len(base_toks) + 1:] = True  # predicted: residues + stop
        qmasks.append(qm)

    t = max(len(r) for r in rows)
    n = len(rows)
    tokens = np.full((n, t), MASK_X, np.int32)
    segments = np.zeros((n, t), np.int32)
    positions = np.zeros((n, t), np.int32)
    valid = np.zeros((n, t), bool)
    qmask = np.zeros((n, t), bool)
    for i in range(n):
        ln_i = len(rows[i])
        tokens[i, :ln_i] = rows[i]
        segments[i, :ln_i] = segs[i]
        positions[i, :ln_i] = poss[i]
        valid[i, :ln_i] = True
        qmask[i, :ln_i] = qmasks[i]
    return tokens, segments, positions, valid, qmask


@torch.no_grad()
def token_logprobs(model: PoetModel, tokens, segments, positions, valid) -> torch.Tensor:
    """(B, T) row arrays on the model's device -> (B, T-1) float32
    log p(token t+1 | tokens <= t)."""
    logps = torch.log_softmax(model(tokens, segments, positions, valid), dim=-1)
    return logps[:, :-1].gather(-1, tokens[:, 1:, None].long())[..., 0]


def score_queries(
    model: PoetModel,
    context: Sequence[str],
    queries: Sequence[str],
    batch_size: int = 8,
) -> np.ndarray:
    """log p(query | context) summed over query tokens (incl. stop)."""
    tokens, segments, positions, valid, qmask = build_rows(context, queries)
    dev = model.token_embed.weight.device
    out = np.zeros(len(queries))
    for s in range(0, len(queries), batch_size):
        e = min(s + batch_size, len(queries))
        tok, seg, pos, val, qm = (torch.from_numpy(a[s:e]).to(dev)
                                  for a in (tokens, segments, positions, valid, qmask))
        ll = token_logprobs(model, tok, seg, pos, val)
        out[s:e] = torch.where(qm[:, 1:], ll, 0.0).sum(dim=1).cpu().numpy()
    return out


def score_assay_poet(
    model: PoetModel,
    mutated_sequences: Sequence[str],
    msa_sequences: Sequence[str],
    msa_weights: Optional[np.ndarray] = None,
    max_context_tokens: int = 4096,
    n_context_samples: int = 2,
    seed: int = 0,
    batch_size: int = 8,
) -> np.ndarray:
    """Ensemble over weighted context samples (ref scripts/score.py)."""
    acc = np.zeros(len(mutated_sequences))
    for s in range(n_context_samples):
        ctx = sample_context(msa_sequences, msa_weights, max_context_tokens, seed + s)
        acc += score_queries(model, ctx, mutated_sequences, batch_size=batch_size)
    return acc / n_context_samples
