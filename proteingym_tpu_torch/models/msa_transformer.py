"""MSA Transformer (ESM-MSA-1b) as a PyTorch module, with its weighted MSA
subsampling and masked-marginal scoring (counterpart of
proteingym_tpu/models/msa_transformer.py).

Semantics match the JAX ``apply``:

- embedding: token embedding, learned column positions (cumsum of non-pad
  tokens times non-pad, plus ``padding_idx``), the learned per-row MSA
  position embedding, ``emb_layer_norm_before``, pad tokens zeroed;
- tied row attention: q scaled by ``head_dim**-0.5 / sqrt(R)`` with padded
  query positions zeroed, scores summed over rows in float32, key pads
  (read from row 0) filled with -10000, a float32 softmax rounded to the
  model dtype before P.V, which accumulates in float32;
- column attention: attention over the R rows of each column, batched over
  (batch, column), through ``mha`` with the key mask (the grouped kernel,
  K1, up to 1,024 rows); one row takes the identity-on-V shortcut;
- an exact-erf GELU FFN, each block pre-LN residual; ``emb_layer_norm_after``
  and the Roberta LM head tied to the token embedding, float32 logits.

Parameter names follow fair-esm's ``MSATransformer``, so a fair-esm state
dict loads by name. Dense and embedding weights are held in
``config.dtype``; layer norms and the LM-head bias stay float32.

Scoring (ref esm/compute_fitness.py): each forward masks first-row
(query) columns of the sampled MSA and reads the log-softmax of row 0 at
them; the grids of a chunk are built on the device.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Mapping, Sequence

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.data.windows import get_optimal_window
from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.esm2 import ALPHABET, LayerNorm, LMHead
from proteingym_tpu_torch.models.state_dict import copy_state_dict
from proteingym_tpu_torch.models.esm_scoring import score_mutants_from_table
from proteingym_tpu_torch.ops.flash_attention import mha

# the fill of padded keys in the tied row attention (the reference's, not
# the attention kernels' -1e30)
ROW_PAD_FILL = -10000.0


@dataclasses.dataclass(frozen=True)
class MsaTransformerConfig:
    name: str = "esm_msa1b_t12_100M"
    num_layers: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    ffn_dim: int = 3072
    alphabet_size: int = 33
    max_positions: int = 1024
    max_rows: int = 1024
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


PRESETS: Dict[str, MsaTransformerConfig] = {
    "esm_msa1b_t12_100M": MsaTransformerConfig(),
    # float32 tiny config for CPU tests (bf16 in the JAX package)
    "msa_tiny": MsaTransformerConfig(
        name="msa_tiny", num_layers=2, embed_dim=64, num_heads=4, ffn_dim=128,
        dtype=torch.float32,
    ),
}


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched product with float32 output: the exact product of the
    operands accumulated in float32 (JAX's ``preferred_element_type``).
    cuBLAS takes bf16 in and gives float32 out; the CPU has no such
    kernel, so there the operands are widened first (the same numbers)."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


class _AxialAttention(nn.Module):
    """The q/k/v and output projections both axial attentions hold."""

    def __init__(self, config: MsaTransformerConfig, device=None):
        super().__init__()
        d, kw = config.embed_dim, dict(device=device, dtype=config.dtype)
        self.num_heads, self.head_dim = config.num_heads, config.head_dim
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)


class RowSelfAttention(_AxialAttention):
    """Tied row attention: one softmax over columns, shared by every row,
    from scores summed over the rows."""

    def forward(self, x, pad_mask, col_pad):
        b, r, c, d = x.shape
        h, hd = self.num_heads, self.head_dim

        def heads(y):  # (B, R, C, D) -> (B*H, C, R*hd): a head's rows side by side
            return y.view(b, r, c, h, hd).permute(0, 3, 2, 1, 4).reshape(b * h, c, r * hd)

        q = self.q_proj(x) * (hd ** -0.5 / math.sqrt(r))
        q = q.masked_fill(pad_mask[..., None], 0.0)  # padded queries add nothing to the sums
        scores = _bmm_f32(heads(q), heads(self.k_proj(x)).transpose(1, 2)).view(b, h, c, c)
        scores = scores.masked_fill(col_pad[:, None, None, :], ROW_PAD_FILL)
        probs = torch.softmax(scores, dim=-1).to(x.dtype).view(b * h, c, c)
        ctx = torch.bmm(probs, heads(self.v_proj(x)))  # (B*H, C, R*hd)
        ctx = ctx.view(b, h, c, r, hd).permute(0, 3, 2, 1, 4).reshape(b, r, c, d)
        return self.out_proj(ctx)


class ColumnSelfAttention(_AxialAttention):
    """Attention over the rows of each column, batched over (batch, column)."""

    def forward(self, x, key_mask):
        b, r, c, d = x.shape
        if r == 1:  # a softmax over one row is the identity on V
            return self.out_proj(self.v_proj(x))
        h, hd = self.num_heads, self.head_dim

        def columns(y, scale=1.0):
            # (B, R, C, D) -> (B*C, H, R, hd), over (B, C, R, H, hd) memory:
            # one copy, which for q also applies the softmax scale
            # (bf16(q * scale), the kernels' pre-pass rounding)
            out = torch.empty((b, c, r, h, hd), dtype=y.dtype, device=y.device)
            torch.mul(y.view(b, r, c, h, hd).transpose(1, 2), scale, out=out)
            return out.view(b * c, r, h, hd).transpose(1, 2)

        ctx = mha(columns(self.q_proj(x), hd ** -0.5), columns(self.k_proj(x)),
                  columns(self.v_proj(x)), key_mask=key_mask, sm_scale=1.0)
        # (B*C, H, R, hd) -> (B, R, C, D)
        ctx = ctx.transpose(1, 2).reshape(b, c, r, d).transpose(1, 2)
        return self.out_proj(ctx)


class FeedForwardNetwork(nn.Module):
    def __init__(self, config: MsaTransformerConfig, device=None):
        super().__init__()
        kw = dict(device=device, dtype=config.dtype)
        self.fc1 = nn.Linear(config.embed_dim, config.ffn_dim, **kw)
        self.fc2 = nn.Linear(config.ffn_dim, config.embed_dim, **kw)

    def forward(self, x):
        return self.fc2(nn.functional.gelu(self.fc1(x)))


class NormalizedResidualBlock(nn.Module):
    """x + layer(layer_norm(x)), fair-esm's pre-LN residual."""

    def __init__(self, layer: nn.Module, dim: int, device=None):
        super().__init__()
        self.layer = layer
        self.layer_norm = LayerNorm(dim, device=device)

    def forward(self, x, *args):
        return x + self.layer(self.layer_norm(x), *args)


class AxialTransformerLayer(nn.Module):
    def __init__(self, config: MsaTransformerConfig, device=None):
        super().__init__()
        d = config.embed_dim
        self.row_self_attention = NormalizedResidualBlock(
            RowSelfAttention(config, device), d, device)
        self.column_self_attention = NormalizedResidualBlock(
            ColumnSelfAttention(config, device), d, device)
        self.feed_forward_layer = NormalizedResidualBlock(
            FeedForwardNetwork(config, device), d, device)

    def forward(self, x, pad_mask, col_pad, key_mask):
        x = self.row_self_attention(x, pad_mask, col_pad)
        x = self.column_self_attention(x, key_mask)
        return self.feed_forward_layer(x)


class MsaTransformer(nn.Module):
    """(B, R, C) int tokens -> (B, R, C, V) float32 logits."""

    def __init__(self, config: MsaTransformerConfig, device=None):
        super().__init__()
        self.config = config
        d, kw = config.embed_dim, dict(device=device, dtype=config.dtype)
        self.embed_tokens = nn.Embedding(config.alphabet_size, d, **kw)
        self.embed_positions = nn.Embedding(config.max_positions + 2, d, **kw)
        self.msa_position_embedding = nn.Parameter(torch.empty(1, config.max_rows, 1, d, **kw))
        self.emb_layer_norm_before = LayerNorm(d, device=device)
        self.layers = nn.ModuleList(
            AxialTransformerLayer(config, device) for _ in range(config.num_layers))
        self.emb_layer_norm_after = LayerNorm(d, device=device)
        self.lm_head = LMHead(config, device=device)

    def forward(self, tokens: torch.Tensor, query_row_only: bool = False) -> torch.Tensor:
        """With ``query_row_only`` the LM head runs on row 0 alone and the
        result is (B, 1, C, V): the same numbers as the full logits' row 0,
        which is all masked-marginal scoring reads."""
        cfg = self.config
        b, r, c = tokens.shape
        if r > cfg.max_rows or c > cfg.max_positions:
            raise ValueError(f"{r} rows x {c} columns: the model takes at most "
                             f"{cfg.max_rows} rows and {cfg.max_positions} columns")
        pad = ALPHABET.padding_idx
        pad_mask = tokens == pad
        live = (~pad_mask).long()
        x = self.embed_tokens(tokens)
        x = x + self.embed_positions(torch.cumsum(live, dim=-1) * live + pad)
        x = x + self.msa_position_embedding[0, :r]
        x = self.emb_layer_norm_before(x)
        x = x.masked_fill(pad_mask[..., None], 0.0)
        col_pad = pad_mask[:, 0]  # the row attention's key pads, from row 0
        key_mask = (~pad_mask).transpose(1, 2).reshape(b * c, r)  # the column attention's
        for layer in self.layers:
            x = layer(x, pad_mask, col_pad, key_mask)
        if query_row_only:
            x = x[:, :1]
        x = self.emb_layer_norm_after(x)
        return self.lm_head(x, self.embed_tokens.weight)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _empty_model(config: MsaTransformerConfig, device) -> MsaTransformer:
    with torch.device("meta"):
        model = MsaTransformer(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: MsaTransformerConfig, seed: int = 0, device="cuda") -> MsaTransformer:
    """Seeded random init with the JAX ``init_params`` distribution (the
    draws differ): dense weights and the token and column-position
    embeddings N(0, 0.02^2), the MSA row embedding N(0, 0.01^2), zero
    biases, unit LN scales."""
    model = _empty_model(config, device)
    dev = model.embed_tokens.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(p, std):
        p.copy_(torch.randn(tuple(p.shape), generator=gen, device=dev) * std)

    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Embedding)):
            normal(module.weight, 0.02)
            if isinstance(module, nn.Linear):
                module.bias.zero_()
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    normal(model.msa_position_embedding, 0.01)
    model.lm_head.bias.zero_()
    return model


def load_fair_esm_state_dict(state_dict: Mapping, config: MsaTransformerConfig,
                             device="cuda") -> MsaTransformer:
    """Build the model from a fair-esm ``MSATransformer`` state dict
    (tensors or numpy arrays; keys with or without the ``encoder.``
    prefix). Keys the model does not hold (the contact head, the tied
    ``lm_head.weight``) are ignored; a key it needs and does not find, or
    one of another shape, raises."""
    if any(key.startswith("encoder.") for key in state_dict):
        state_dict = {key[len("encoder."):]: v for key, v in state_dict.items()
                      if key.startswith("encoder.")}
    return copy_state_dict(_empty_model(config, device), state_dict, config.name)


def params_from_jax(params, config: MsaTransformerConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as a fair-esm-named state dict.
    JAX dense kernels are (in, out); torch Linear weights are (out, in)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def dense(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["w"]).T)
        put(f"{prefix}.bias", p["b"])

    def ln(prefix, p):
        put(f"{prefix}.weight", p["g"])
        put(f"{prefix}.bias", p["b"])

    put("embed_tokens.weight", params["embed_tokens"])
    put("embed_positions.weight", params["embed_positions"])
    put("msa_position_embedding", np.asarray(params["msa_position_embedding"])[None])
    ln("emb_layer_norm_before", params["emb_ln_before"])
    ln("emb_layer_norm_after", params["emb_ln_after"])
    for i, layer in enumerate(params["layers"][: config.num_layers]):
        for attn, mod in (("row_attn", "row_self_attention"),
                          ("col_attn", "column_self_attention")):
            p = f"layers.{i}.{mod}"
            for proj, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                               ("o", "out_proj")):
                dense(f"{p}.layer.{name}", layer[attn][proj])
            ln(f"{p}.layer_norm", layer[attn]["ln"])
        p = f"layers.{i}.feed_forward_layer"
        dense(f"{p}.layer.fc1", layer["ffn"]["fc1"])
        dense(f"{p}.layer.fc2", layer["ffn"]["fc2"])
        ln(f"{p}.layer_norm", layer["ffn"]["ln"])
    dense("lm_head.dense", params["lm_head"]["dense"])
    ln("lm_head.layer_norm", params["lm_head"]["ln"])
    put("lm_head.bias", params["lm_head"]["bias"])
    return sd


# ---------------------------------------------------------------------------
# Weighted MSA subsampling (ref esm/compute_fitness.py:26-73)
# ---------------------------------------------------------------------------

def sample_msa_weighted(sequences: Sequence[str], weights: np.ndarray, nseq: int,
                        seed: int) -> List[str]:
    """The focus row (the first) first, then ``nseq - 1`` rows drawn with
    replacement with probability proportional to their weights (Python's
    ``random.Random(seed).choices``); every row upper-cased."""
    rng = random.Random(seed)
    others = list(range(1, len(sequences)))
    out = [sequences[0]]
    if others:
        w = np.asarray([weights[i] for i in others], dtype=np.float64)
        w = w / w.sum()
        picks = rng.choices(others, weights=w.tolist(), k=nseq - 1)
        out.extend(sequences[i] for i in picks)
    return [s.upper() for s in out]


def tokenize_msa(sequences: Sequence[str]) -> np.ndarray:
    """(R, C+1) int32 tokens: each row is [CLS] + sequence (no EOS)."""
    return np.asarray(
        [[ALPHABET.cls_idx] + [ALPHABET.get_idx(ch) for ch in seq] for seq in sequences],
        dtype=np.int32,
    )


# ---------------------------------------------------------------------------
# Masked-marginal scoring
# ---------------------------------------------------------------------------

def _k_column_grids(total: int, k: int, chunk: int):
    """The short path's work plan: each grid masks k first-row columns,
    assigned with maximum stride (grid g masks g, g + n_grids, ...), so a
    grid's masked columns sit ~total/k apart. Returns (offsets, valid),
    both (n_pad, k) with n_pad the grid count rounded up to ``chunk``: a
    grid's pad slots repeat its own first column (re-masking a masked
    column changes nothing) and the tail grids, all offset 0, are not
    valid."""
    n_grids = -(-total // k)
    n_flat = n_grids * k
    offs = np.concatenate([np.arange(total), np.zeros(n_flat - total, np.int64)])
    valid = np.arange(n_flat) < total
    offs = offs.reshape(k, n_grids).T
    valid = valid.reshape(k, n_grids).T
    offs = np.where(valid, offs, offs[:, :1])
    n_pad = -(-n_grids // chunk) * chunk
    offs = np.concatenate([offs, np.zeros((n_pad - n_grids, k), np.int64)])
    valid = np.concatenate([valid, np.zeros((n_pad - n_grids, k), bool)])
    return offs, valid


def _query_log_probs(model, grids, offs):
    """log-softmax of row 0 at each grid's masked columns: grids (n, R, C),
    offs (n, k) -> (n, k, V) float32."""
    logits = model(grids, query_row_only=True)[:, 0]  # (n, C, V)
    rows = torch.arange(grids.shape[0], device=grids.device)[:, None]
    return torch.log_softmax(logits[rows, offs].float(), dim=-1)


@torch.no_grad()
def masked_marginal_table_msa(
    model: MsaTransformer,
    msa_tokens: np.ndarray,
    chunk: int = 4,
    window: int = 1024,
    cols_per_forward: int = 1,
) -> torch.Tensor:
    """(C, V) float32 log-prob table on the model's device; row i from a
    forward with first-row column i masked, ``chunk`` grids per forward.

    Up to ``window`` columns, one (R, C) upload and each chunk's grids
    built on the device. ``cols_per_forward`` (k) > 1 masks k columns per
    grid, assigned with maximum stride, and reads each masked column's own
    row (~C/k forwards; an opt-in approximation: a column's context holds
    k - 1 other masked columns; k = 1 is the reference protocol). Longer
    alignments score each column inside its optimal window of ``window``
    columns (k = 1), each chunk's grids cut from the uploaded alignment
    as it goes."""
    mask_idx = ALPHABET.mask_idx
    device = next(model.parameters()).device
    msa_tokens = np.asarray(msa_tokens)
    r, total = msa_tokens.shape
    base = torch.as_tensor(msa_tokens, dtype=torch.long, device=device)
    lanes = torch.arange(chunk, device=device)[:, None]

    if total <= window:
        k = max(1, min(int(cols_per_forward), total))
        offsets, valid = _k_column_grids(total, k, chunk)
        offs_d = torch.as_tensor(offsets, device=device).view(-1, chunk, k)
        parts = []
        for offs in offs_d:
            grids = base.expand(chunk, r, total).clone()
            grids[lanes, 0, offs] = mask_idx
            parts.append(_query_log_probs(model, grids, offs))
        flat = torch.cat(parts).reshape(-1, parts[0].shape[-1])
        if k == 1:
            return flat[:total]
        sel = torch.as_tensor(valid.reshape(-1), device=device)
        table = torch.zeros(total, flat.shape[-1], dtype=flat.dtype, device=device)
        table[offs_d.reshape(-1)[sel]] = flat[sel]
        return table

    n_pad = -(-total // chunk) * chunk
    starts = np.zeros(n_pad, np.int64)
    offsets = np.zeros(n_pad, np.int64)
    for i in range(total):
        start, _ = get_optimal_window(i, total, window)
        starts[i], offsets[i] = start, i - start
    starts_d = torch.as_tensor(starts, device=device).view(-1, chunk)
    offs_d = torch.as_tensor(offsets, device=device).view(-1, chunk, 1)
    span = torch.arange(window, device=device)
    parts = []
    for st, offs in zip(starts_d, offs_d):
        grids = base[:, st[:, None] + span].transpose(0, 1).contiguous()  # (chunk, R, window)
        grids[lanes, 0, offs] = mask_idx
        parts.append(_query_log_probs(model, grids, offs))
    return torch.cat(parts)[:total, 0]


def score_assay_msa_transformer(
    model: MsaTransformer,
    sequence: str,
    mutants: Sequence[str],
    msa_sequences: Sequence[str],
    msa_weights: np.ndarray,
    nseq: int = 384,
    seeds: Sequence[int] = (1, 2, 3, 4, 5),
    chunk: int = 4,
    cols_per_forward: int = 1,
) -> np.ndarray:
    """Masked-marginal scores of 1-based ``mutants`` of ``sequence`` (the
    alignment's first row), averaged over MSA subsample seeds (ref
    :530-542 averages the per-seed columns)."""
    per_seed = []
    for seed in seeds:
        tokens = tokenize_msa(sample_msa_weighted(msa_sequences, msa_weights, nseq, seed))
        table = masked_marginal_table_msa(model, tokens, chunk=chunk,
                                          cols_per_forward=cols_per_forward)
        per_seed.append(score_mutants_from_table(table, mutants, sequence))
    return np.mean(np.stack(per_seed), axis=0)
