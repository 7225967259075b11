"""ESM family (ESM2 / ESM-1b / ESM-1v) as a PyTorch module (counterpart of
proteingym_tpu/models/esm2.py).

Semantics match the JAX ``apply``: token-dropout rescale at inference
(global or per packed segment), rotary q/k (ESM2) or learned positions
that restart per segment (ESM-1b/1v), the ESM-1b embedding pre-LN, pre-LN
transformer blocks with q scaled after its bias, exact-erf GELU, the final
LN, and the Roberta LM head tied to the token embedding.

Parameter names follow fair-esm, so a fair-esm state dict loads by name.
Dense and embedding weights are held in ``config.dtype``; layer-norm
parameters and the LM-head bias stay float32 and the logits are float32,
as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.ops.flash_attention import KeyTiles, mha_natural

# upper bound on independent sequences per packed row (one-hot width)
MAX_ROW_SEGMENTS = 28

_PROTEINSEQ_TOKS = [
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
]


class EsmAlphabet:
    """Token vocabulary with ESM-1b/ESM2 ordering."""

    def __init__(self):
        prepend = ["<cls>", "<pad>", "<eos>", "<unk>"]
        toks = prepend + list(_PROTEINSEQ_TOKS)
        while len(toks) % 8 != 0:
            toks.append(f"<null_{len(toks) - len(prepend) - len(_PROTEINSEQ_TOKS) + 1}>")
        toks.append("<mask>")
        self.all_toks = toks
        self.tok_to_idx = {t: i for i, t in enumerate(toks)}
        self.cls_idx = self.tok_to_idx["<cls>"]
        self.padding_idx = self.tok_to_idx["<pad>"]
        self.eos_idx = self.tok_to_idx["<eos>"]
        self.unk_idx = self.tok_to_idx["<unk>"]
        self.mask_idx = self.tok_to_idx["<mask>"]

    def __len__(self):
        return len(self.all_toks)

    def get_idx(self, tok: str) -> int:
        return self.tok_to_idx.get(tok, self.unk_idx)

    def tokenize(self, seq: str, pad_to: Optional[int] = None) -> np.ndarray:
        """<cls> + seq + <eos> (+ padding)."""
        ids = [self.cls_idx] + [self.get_idx(c) for c in seq] + [self.eos_idx]
        if pad_to is not None:
            ids = ids + [self.padding_idx] * (pad_to - len(ids))
        return np.asarray(ids, dtype=np.int32)


ALPHABET = EsmAlphabet()


@dataclasses.dataclass(frozen=True)
class EsmConfig:
    name: str = "esm2_t33_650M"
    num_layers: int = 33
    embed_dim: int = 1280
    num_heads: int = 20
    alphabet_size: int = 33
    token_dropout: bool = True
    use_rotary: bool = True  # ESM2; False -> learned positions (ESM-1b/1v)
    emb_layer_norm_before: bool = False  # ESM-1b only
    max_positions: int = 1024  # learned positional embeddings; scoring window
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def ffn_dim(self) -> int:
        return 4 * self.embed_dim


PRESETS: Dict[str, EsmConfig] = {
    # float32 tiny config for CPU tests
    "esm2_tiny": EsmConfig("esm2_tiny", 2, 128, 4, dtype=torch.float32),
    "esm2_t6_8M": EsmConfig("esm2_t6_8M", 6, 320, 20),
    "esm2_t12_35M": EsmConfig("esm2_t12_35M", 12, 480, 20),
    "esm2_t30_150M": EsmConfig("esm2_t30_150M", 30, 640, 20),
    "esm2_t33_650M": EsmConfig("esm2_t33_650M", 33, 1280, 20),
    "esm2_t36_3B": EsmConfig("esm2_t36_3B", 36, 2560, 40),
    "esm2_t48_15B": EsmConfig("esm2_t48_15B", 48, 5120, 40),
    "esm1b_t33_650M": EsmConfig(
        "esm1b_t33_650M", 33, 1280, 20,
        use_rotary=False, emb_layer_norm_before=True, token_dropout=True,
    ),
    "esm1v_t33_650M": EsmConfig(
        "esm1v_t33_650M", 33, 1280, 20,
        use_rotary=False, emb_layer_norm_before=False, token_dropout=True,
    ),
}


class LayerNorm(nn.Module):
    """Layer norm computed in float32 with float32 parameters, returned in
    the input dtype."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, 1e-5).to(x.dtype)


class SelfAttention(nn.Module):
    def __init__(self, config: EsmConfig, device=None):
        super().__init__()
        d, kw = config.embed_dim, dict(device=device, dtype=config.dtype)
        self.num_heads = config.num_heads
        self.head_dim = config.head_dim
        self.scaling = self.head_dim ** -0.5
        self.rope_base = 10000.0 if config.use_rotary else None
        self.q_proj = nn.Linear(d, d, **kw)
        self.k_proj = nn.Linear(d, d, **kw)
        self.v_proj = nn.Linear(d, d, **kw)
        self.out_proj = nn.Linear(d, d, **kw)

    def forward(self, x, key_mask, segment_ids=None, key_tiles=None):
        b, t, d = x.shape

        def heads(y):  # (B, T, D) -> (B, T, H, hd) view, no copy
            return y.view(b, t, self.num_heads, self.head_dim)

        # the softmax scale is applied to q after its bias; RoPE is linear,
        # so the kernel rotates the pre-scaled q exactly
        q = heads(self.q_proj(x) * self.scaling)
        ctx = mha_natural(q, heads(self.k_proj(x)), heads(self.v_proj(x)),
                          key_mask=key_mask, sm_scale=1.0, rope_base=self.rope_base,
                          segment_ids=segment_ids, key_tiles=key_tiles)
        return self.out_proj(ctx.reshape(b, t, d))


class TransformerLayer(nn.Module):
    def __init__(self, config: EsmConfig, device=None):
        super().__init__()
        d, kw = config.embed_dim, dict(device=device, dtype=config.dtype)
        self.self_attn_layer_norm = LayerNorm(d, device=device)
        self.self_attn = SelfAttention(config, device=device)
        self.final_layer_norm = LayerNorm(d, device=device)
        self.fc1 = nn.Linear(d, config.ffn_dim, **kw)
        self.fc2 = nn.Linear(config.ffn_dim, d, **kw)

    def forward(self, x, key_mask, segment_ids=None, key_tiles=None):
        x = x + self.self_attn(self.self_attn_layer_norm(x), key_mask, segment_ids, key_tiles)
        return x + self.fc2(F.gelu(self.fc1(self.final_layer_norm(x))))


class LMHead(nn.Module):
    """Roberta LM head: dense -> GELU -> LN -> linear tied to the token
    embedding, with a float32 bias."""

    def __init__(self, config: EsmConfig, device=None):
        super().__init__()
        d = config.embed_dim
        self.dense = nn.Linear(d, d, device=device, dtype=config.dtype)
        self.layer_norm = LayerNorm(d, device=device)
        self.bias = nn.Parameter(torch.zeros(config.alphabet_size, device=device))

    def forward(self, x, embed_weight):
        h = self.layer_norm(F.gelu(self.dense(x)))
        # float32 product of the stored-dtype operands (the JAX head takes
        # bf16 operands with float32 accumulation)
        return torch.matmul(h.float(), embed_weight.float().t()) + self.bias


class EsmModel(nn.Module):
    """(B, T) int tokens -> (B, T, V) float32 logits."""

    def __init__(self, config: EsmConfig, device=None):
        super().__init__()
        self.config = config
        d, kw = config.embed_dim, dict(device=device, dtype=config.dtype)
        self.embed_tokens = nn.Embedding(config.alphabet_size, d, **kw)
        if not config.use_rotary:
            self.embed_positions = nn.Embedding(config.max_positions + 2, d, **kw)
            if config.emb_layer_norm_before:
                self.emb_layer_norm_before = LayerNorm(d, device=device)
        self.layers = nn.ModuleList(
            TransformerLayer(config, device=device) for _ in range(config.num_layers)
        )
        self.emb_layer_norm_after = LayerNorm(d, device=device)
        self.lm_head = LMHead(config, device=device)

    def forward(self, tokens: torch.Tensor, segment_ids: Optional[torch.Tensor] = None,
                return_representations: bool = False):
        """``segment_ids`` (B, T) int, 0 = padding, 1..S contiguous: each row
        packs independent sequences, each scored as if alone (block-diagonal
        attention, per-segment token-dropout scale, positions restarting per
        segment). With ``return_representations`` returns (logits, reps),
        reps[i] the output of layer i and reps[num_layers] the
        post-final-LN tensor (fair-esm's convention)."""
        cfg = self.config
        pad, mask_idx = ALPHABET.padding_idx, ALPHABET.mask_idx
        padding_mask = tokens == pad
        seg_onehot = None
        if segment_ids is not None:
            seg_onehot = (
                segment_ids[..., None]
                == torch.arange(1, MAX_ROW_SEGMENTS + 1, device=tokens.device)
            ).float()  # (B, T, S)

        x = self.embed_tokens(tokens)
        if cfg.token_dropout:
            is_masked = tokens == mask_idx
            x = x.masked_fill(is_masked[..., None], 0.0)
            mask_ratio_train = 0.15 * 0.8
            if seg_onehot is None:
                src_lengths = (~padding_mask).sum(-1).clamp(min=1)
                mask_ratio_obs = is_masked.sum(-1).float() / src_lengths
                scale = (1 - mask_ratio_train) / (1 - mask_ratio_obs)
                x = x * scale[:, None, None].to(x.dtype)
            else:
                seg_len = seg_onehot.sum(1)
                seg_masked = torch.einsum("bts,bt->bs", seg_onehot, is_masked.float())
                seg_scale = (1 - mask_ratio_train) / (1 - seg_masked / seg_len.clamp(min=1.0))
                tok_scale = torch.einsum("bts,bs->bt", seg_onehot, seg_scale)
                x = x * tok_scale[..., None].to(x.dtype)

        if not cfg.use_rotary:
            if seg_onehot is None:
                live = (~padding_mask).long()
                pos = torch.cumsum(live, dim=1) * live + pad
            else:
                # rank of the token within its own segment (+ padding_idx)
                rank = (seg_onehot * torch.cumsum(seg_onehot, dim=1)).sum(-1).long()
                pos = torch.where(segment_ids > 0, rank + pad, torch.full_like(rank, pad))
            x = x + self.embed_positions(pos)
            if cfg.emb_layer_norm_before:
                x = self.emb_layer_norm_before(x)

        x = x.masked_fill(padding_mask[..., None], 0.0)
        key_mask = ~padding_mask
        # the segmented layers' key-tile extents, found once for all of them
        key_tiles = KeyTiles(segment_ids, key_mask) if segment_ids is not None else None
        reps = {}
        for i, layer in enumerate(self.layers):
            x = layer(x, key_mask, segment_ids, key_tiles)
            if return_representations:
                reps[i + 1] = x
        x = self.emb_layer_norm_after(x)
        if return_representations:
            reps[cfg.num_layers] = x
        logits = self.lm_head(x, self.embed_tokens.weight)
        if return_representations:
            return logits, reps
        return logits


def make_segmented_apply_fn(model: EsmModel) -> EsmModel:
    """The (tokens, segment_ids) -> logits callable for segment-packed rows
    (see ``EsmModel.forward``'s ``segment_ids`` contract). The JAX helper
    closes over a config so that one jitted program serves every caller;
    the module carries its own weights, so here it is the model itself."""
    return model


def _empty_model(config: EsmConfig, device) -> EsmModel:
    with torch.device("meta"):
        model = EsmModel(config)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: EsmConfig, seed: int = 0, device="cuda") -> EsmModel:
    """Random-normal init from a seeded ``torch.Generator`` on ``device``:
    dense weights N(0, 1/n_in), zero biases, unit LN scales, embeddings
    N(0, 0.02^2) (the JAX ``init_params`` distribution; the draws differ)."""
    model = _empty_model(config, device)
    gen = torch.Generator(device=model.embed_tokens.weight.device).manual_seed(seed)
    for module in model.modules():
        if isinstance(module, nn.Linear):
            n_out, n_in = module.weight.shape
            module.weight.copy_(_randn((n_out, n_in), gen, module.weight.device)
                                / math.sqrt(n_in))
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.copy_(_randn(module.weight.shape, gen, module.weight.device) * 0.02)
        elif isinstance(module, LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
    model.lm_head.bias.zero_()
    return model


def _randn(shape, gen, device):
    return torch.randn(tuple(shape), generator=gen, device=device, dtype=torch.float32)


@torch.no_grad()
def load_fair_esm_state_dict(state_dict: Mapping, config: EsmConfig,
                             device="cuda") -> EsmModel:
    """Build the model from a fair-esm checkpoint's state dict (tensors or
    numpy arrays). Keys the model does not hold (contact head, rotary
    ``inv_freq`` buffers, the tied ``lm_head.weight``) are ignored; a key it
    needs and does not find raises."""
    model = _empty_model(config, device)
    for name, param in model.state_dict().items():
        if name not in state_dict:
            raise KeyError(f"checkpoint for {config.name} lacks {name!r}")
        value = state_dict[name]
        if not torch.is_tensor(value):
            value = torch.from_numpy(np.asarray(value, dtype=np.float32))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(value.shape)}, "
                             f"model shape {tuple(param.shape)}")
        param.copy_(value.to(device=param.device, dtype=torch.float32))
    return model


def params_from_jax(params, config: EsmConfig) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as a fair-esm-named state dict.
    JAX dense kernels are (in, out); torch Linear weights are (out, in)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value):
        sd[key] = torch.from_numpy(np.array(value, dtype=np.float32))

    def dense(prefix, p):
        put(f"{prefix}.weight", np.asarray(p["kernel"]).T)
        put(f"{prefix}.bias", p["bias"])

    def ln(prefix, p):
        put(f"{prefix}.weight", p["scale"])
        put(f"{prefix}.bias", p["bias"])

    put("embed_tokens.weight", params["embed_tokens"])
    for i, layer in enumerate(params["layers"][: config.num_layers]):
        p = f"layers.{i}"
        ln(f"{p}.self_attn_layer_norm", layer["attn_ln"])
        for proj in ("q", "k", "v", "out"):
            dense(f"{p}.self_attn.{proj}_proj", layer[proj])
        ln(f"{p}.final_layer_norm", layer["ffn_ln"])
        dense(f"{p}.fc1", layer["fc1"])
        dense(f"{p}.fc2", layer["fc2"])
    ln("emb_layer_norm_after", params["final_ln"])
    dense("lm_head.dense", params["lm_head"]["dense"])
    ln("lm_head.layer_norm", params["lm_head"]["ln"])
    put("lm_head.bias", params["lm_head"]["bias"])
    if not config.use_rotary:
        put("embed_positions.weight", params["embed_positions"])
        if config.emb_layer_norm_before:
            ln("emb_layer_norm_before", params["emb_ln_before"])
    return sd
