"""ProtT5 (T5 encoder and decoder) in PyTorch, the trunk of VESPA
(counterpart of proteingym_tpu/models/prot_t5.py; HF
transformers/models/t5/modeling_t5.py semantics, Rostlab/prot_t5_xl_uniref50).

The modules take the HF ``T5EncoderModel`` / ``T5ForConditionalGeneration``
parameter names, so a published state dict loads by name:

  - RMS layer norm without a mean or a bias, eps 1e-6, pre-norm blocks and
    a final norm after each stack
  - no softmax scale (T5 folds 1/sqrt(d_kv) into its initialisation)
  - bias-free q/k/v/o and FFN projections; d_kv independent of d_model
  - the relative position bias of block 0 (32 buckets, max distance 128),
    bucketed once in numpy and added to the scores of every layer; PAD keys
    get -1e9 (HF's extended attention mask), not the kernels' -1e30
  - a relu FFN (v1.0, ProtT5) or the gated tanh-GELU FFN (v1.1 wi_0/wi_1),
    found from the state dict
  - the decoder: unidirectional buckets, a -1e9 causal bias, bias-free
    cross attention, and a tied head scaled by d_model**-0.5

The (B, H, T, T) additive bias is outside the grouped kernel's key-bias
form (the JAX package runs it in XLA), so attention is plain ``matmul`` +
softmax here.

Tokenizer note: ProtT5's sentencepiece ids (pad=0, </s>=1, unk=2, then the
amino acids) ship with the published tokenizer. ``AA_TOKEN_IDS`` is the
JAX package's reconstruction of that layout, copied; pass ``token_ids=``
to override.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.state_dict import Named, copy_state_dict

PAD_ID, EOS_ID, UNK_ID = 0, 1, 2
AA_TOKEN_IDS = {aa: 3 + i for i, aa in enumerate("ALGVSREDTIPKFQNYMHWCXBOUZ")}
DECODER_START_ID = PAD_ID  # T5's decoder_start_token_id is pad
MASK_BIAS = -1e9  # HF's additive mask value


@dataclasses.dataclass(frozen=True)
class ProtT5Config:
    name: str = "prot_t5"
    vocab_size: int = 128
    d_model: int = 1024
    d_kv: int = 128
    num_heads: int = 32
    num_layers: int = 24
    d_ff: int = 16384
    num_buckets: int = 32
    max_distance: int = 128
    gated: bool = False  # v1.1 wi_0/wi_1 gated act; ProtT5 is v1.0 relu
    dtype: torch.dtype = torch.float32


PRESETS = {
    # Rostlab/prot_t5_xl_uniref50 (the VESPA trunk)
    "prot_t5_xl": ProtT5Config(name="prot_t5_xl"),
    "prot_t5_tiny": ProtT5Config(name="prot_t5_tiny", vocab_size=48, d_model=64, d_kv=16,
                                 num_heads=4, num_layers=2, d_ff=128),
}


def tokenize(seq: str, pad_to: Optional[int] = None,
             token_ids: Optional[Dict[str, int]] = None) -> np.ndarray:
    """One token per residue, then </s>; PAD after it up to ``pad_to``."""
    ids = token_ids or AA_TOKEN_IDS
    row = [ids.get(a, UNK_ID) for a in seq.upper()] + [EOS_ID]
    if pad_to is not None:
        if pad_to < len(row):
            raise ValueError(f"pad_to={pad_to} < sequence length + EOS = {len(row)}")
        row = row + [PAD_ID] * (pad_to - len(row))
    return np.asarray(row, np.int64)


def sentinel_id(c: ProtT5Config, k: int = 0) -> int:
    """<extra_id_k>: the sentinels fill the top of the vocabulary in reverse."""
    return c.vocab_size - 1 - k


# ---------------------------------------------------------------------------
# relative position buckets (numpy, as the JAX package computes them)

def _relative_position_bucket(relative_position: np.ndarray, num_buckets: int = 32,
                              max_distance: int = 128) -> np.ndarray:
    """Bidirectional bucket map, transcribed from HF
    T5Attention._relative_position_bucket."""
    num_buckets //= 2
    buckets = (relative_position > 0).astype(np.int64) * num_buckets
    rel = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)
    ).astype(np.int64)
    rel_large = np.minimum(rel_large, num_buckets - 1)
    return buckets + np.where(is_small, rel, rel_large)


def position_bias_buckets(t: int, c: ProtT5Config) -> np.ndarray:
    """(T, T) bidirectional bucket indices of key_pos - query_pos."""
    return _relative_position_bucket(np.arange(t)[None, :] - np.arange(t)[:, None],
                                     num_buckets=c.num_buckets, max_distance=c.max_distance)


def decoder_buckets(t: int, c: ProtT5Config) -> np.ndarray:
    """(T, T) unidirectional bucket indices (only past keys count)."""
    neg = -np.minimum(np.arange(t)[None, :] - np.arange(t)[:, None], 0)
    max_exact = c.num_buckets // 2
    large = max_exact + (
        np.log(np.maximum(neg, 1) / max_exact)
        / math.log(c.max_distance / max_exact)
        * (c.num_buckets - max_exact)
    ).astype(np.int64)
    return np.where(neg < max_exact, neg, np.minimum(large, c.num_buckets - 1))


# ---------------------------------------------------------------------------
# modules in the HF names

class T5LayerNorm(nn.Module):
    def __init__(self, d: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device, dtype=dtype))


def _attention(c: ProtT5Config, relative: bool, kw) -> Named:
    inner = c.num_heads * c.d_kv
    mods = dict(q=nn.Linear(c.d_model, inner, bias=False, **kw),
                k=nn.Linear(c.d_model, inner, bias=False, **kw),
                v=nn.Linear(c.d_model, inner, bias=False, **kw),
                o=nn.Linear(inner, c.d_model, bias=False, **kw))
    if relative:
        mods["relative_attention_bias"] = nn.Embedding(c.num_buckets, c.num_heads, **kw)
    return Named(**mods)


def _ffn(c: ProtT5Config, kw) -> Named:
    wi = (dict(wi_0=nn.Linear(c.d_model, c.d_ff, bias=False, **kw),
               wi_1=nn.Linear(c.d_model, c.d_ff, bias=False, **kw)) if c.gated
          else dict(wi=nn.Linear(c.d_model, c.d_ff, bias=False, **kw)))
    return Named(**wi, wo=nn.Linear(c.d_ff, c.d_model, bias=False, **kw))


def _stack(c: ProtT5Config, decoder: bool, n_layers: int, kw) -> Named:
    blocks = []
    for i in range(n_layers):
        ln = lambda: T5LayerNorm(c.d_model, **kw)  # noqa: E731
        layers = [Named(SelfAttention=_attention(c, i == 0, kw), layer_norm=ln())]
        if decoder:
            layers.append(Named(EncDecAttention=_attention(c, False, kw), layer_norm=ln()))
        layers.append(Named(DenseReluDense=_ffn(c, kw), layer_norm=ln()))
        blocks.append(Named(layer=nn.ModuleList(layers)))
    return Named(block=nn.ModuleList(blocks), final_layer_norm=T5LayerNorm(c.d_model, **kw))


class ProtT5(nn.Module):
    """``shared``, ``encoder``, optionally ``decoder`` (``decoder_layers``)
    and an untied ``lm_head`` (``tied=False``), in the HF names."""

    def __init__(self, config: ProtT5Config, decoder_layers: int = 0, tied: bool = True,
                 device=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=config.dtype)
        self.shared = nn.Embedding(config.vocab_size, config.d_model, **kw)
        self.encoder = _stack(config, False, config.num_layers, kw)
        self.decoder = _stack(config, True, decoder_layers, kw) if decoder_layers else None
        self.lm_head = (nn.Linear(config.d_model, config.vocab_size, bias=False, **kw)
                        if decoder_layers and not tied else None)


def _rms_norm(x, ln: T5LayerNorm, eps: float = 1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * ln.weight.float()).to(x.dtype)


def _attend(q, k, v, bias):
    """(B, Tq, H, dk) x (B, Tk, H, dk) -> (B, Tq, H, dk): float32 scores plus
    the additive (.., H, Tq, Tk) bias, no softmax scale."""
    scores = torch.matmul(q.transpose(1, 2).float(), k.permute(0, 2, 3, 1).float()) + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v.transpose(1, 2)).transpose(1, 2)


def _project_attend(proj: Named, y, kv, bias, c: ProtT5Config):
    b, tq, tk = y.shape[0], y.shape[1], kv.shape[1]
    q = proj.q(y).view(b, tq, c.num_heads, c.d_kv)
    k = proj.k(kv).view(b, tk, c.num_heads, c.d_kv)
    v = proj.v(kv).view(b, tk, c.num_heads, c.d_kv)
    return proj.o(_attend(q, k, v, bias).reshape(b, tq, c.num_heads * c.d_kv))


def _feed_forward(ffn: Named, y, c: ProtT5Config):
    if c.gated:
        h = (nn.functional.gelu(ffn.wi_0(y).float(), approximate="tanh")
             * ffn.wi_1(y).float())
    else:
        h = torch.relu(ffn.wi(y).float())
    return ffn.wo(h.to(y.dtype))


def _relative_bias(attn: Named, buckets: np.ndarray, device) -> torch.Tensor:
    table = attn.relative_attention_bias.weight.float()
    return table[torch.as_tensor(buckets, device=device)].permute(2, 0, 1)[None]


@torch.no_grad()
def apply(model: ProtT5, tokens: torch.Tensor) -> torch.Tensor:
    """(B, T) int tokens -> (B, T, d_model) float32 final hidden states
    (T5EncoderModel.last_hidden_state); PAD keys masked as HF masks them."""
    c = model.config
    enc = model.encoder
    x = model.shared(tokens)
    pos = _relative_bias(enc.block[0].layer[0].SelfAttention,
                         position_bias_buckets(tokens.shape[1], c), tokens.device)
    bias = pos + torch.where(tokens == PAD_ID, MASK_BIAS, 0.0)[:, None, None, :]
    for block in enc.block:
        att, ff = block.layer
        y = _rms_norm(x, att.layer_norm)
        x = x + _project_attend(att.SelfAttention, y, y, bias, c)
        x = x + _feed_forward(ff.DenseReluDense, _rms_norm(x, ff.layer_norm), c)
    return _rms_norm(x, enc.final_layer_norm).float()


@torch.no_grad()
def embeddings(model: ProtT5, seq: str, token_ids: Optional[Dict[str, int]] = None
               ) -> torch.Tensor:
    """(L, d_model) per-residue embeddings, </s> stripped."""
    dev = model.shared.weight.device
    tokens = torch.as_tensor(tokenize(seq, token_ids=token_ids)[None], device=dev)
    return apply(model, tokens)[0, :len(seq)]


@torch.no_grad()
def decoder_apply(model: ProtT5, dec_tokens: torch.Tensor, enc_hidden: torch.Tensor,
                  enc_pad: torch.Tensor) -> torch.Tensor:
    """The decoder stack -> (B, Td, V) float32 lm logits, from decoder input
    ids (start token first), the encoder's output and its PAD mask."""
    c = model.config
    dec = model.decoder
    t = dec_tokens.shape[1]
    dev = dec_tokens.device
    x = model.shared(dec_tokens)
    causal = torch.triu(torch.ones(t, t, dtype=torch.bool, device=dev), 1)
    self_bias = (_relative_bias(dec.block[0].layer[0].SelfAttention, decoder_buckets(t, c), dev)
                 + torch.where(causal, MASK_BIAS, 0.0))
    cross_bias = torch.where(enc_pad, MASK_BIAS, 0.0)[:, None, None, :]
    enc_kv = enc_hidden.to(c.dtype)
    for block in dec.block:
        att, cross, ff = block.layer
        y = _rms_norm(x, att.layer_norm)
        x = x + _project_attend(att.SelfAttention, y, y, self_bias, c)
        x = x + _project_attend(cross.EncDecAttention, _rms_norm(x, cross.layer_norm), enc_kv,
                                cross_bias, c)
        x = x + _feed_forward(ff.DenseReluDense, _rms_norm(x, ff.layer_norm), c)
    x = _rms_norm(x, dec.final_layer_norm).float()
    if model.lm_head is not None:
        return x @ model.lm_head.weight.float().T
    # tied embedding: HF scales by d_model**-0.5 before the shared head
    return (x * (c.d_model ** -0.5)) @ model.shared.weight.float().T


@torch.no_grad()
def masked_logodds(model: ProtT5, seq: str, token_ids: Optional[Dict[str, int]] = None,
                   chunk: int = 32, positions: Optional[Sequence[int]] = None) -> np.ndarray:
    """(L, V) log-probabilities of the reconstruction at each masked
    position, the VESPA log-odds signal (Marquet et al. 2022): residue i
    replaced by <extra_id_0>, the decoder fed [start, <extra_id_0>], the
    distribution read at slot 1. Rows of ``chunk`` encoder inputs a forward;
    ``positions`` selects the rows (all by default)."""
    if model.decoder is None:
        raise ValueError("masked_logodds needs a decoder-bearing checkpoint "
                         "(a T5ForConditionalGeneration state dict)")
    c = model.config
    dev = model.shared.weight.device
    positions = np.arange(len(seq)) if positions is None else np.asarray(positions)
    base = tokenize(seq, token_ids=token_ids)
    sid = sentinel_id(c)
    rows = np.tile(base[None], (len(positions), 1))
    rows[np.arange(len(positions)), positions] = sid
    out = np.zeros((len(positions), c.vocab_size), np.float32)
    for s0 in range(0, len(positions), chunk):
        blk = torch.as_tensor(rows[s0:s0 + chunk], device=dev)
        enc = apply(model, blk)
        dec_in = torch.tensor([[DECODER_START_ID, sid]], device=dev).expand(len(blk), 2)
        logits = decoder_apply(model, dec_in, enc, blk == PAD_ID)
        out[s0:s0 + len(blk)] = torch.log_softmax(logits[:, 1], dim=-1).cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# weights

def _block_count(state: Mapping, prefix: str) -> int:
    found = {int(k[len(prefix):].split(".", 1)[0]) for k in state if k.startswith(prefix)}
    return 1 + max(found) if found else 0


def config_from_state_dict(sd: Mapping, name: str = "prot_t5") -> ProtT5Config:
    """The configuration an HF T5 state dict implies (the JAX converter's
    reading)."""
    shape = lambda key: tuple(np.shape(sd[key]))  # noqa: E731
    vocab, d_model = shape("shared.weight")
    nb, h = shape("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight")
    inner = shape("encoder.block.0.layer.0.SelfAttention.q.weight")[0]
    gated = "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in sd
    d_ff = shape(f"encoder.block.0.layer.1.DenseReluDense.{'wi_0' if gated else 'wi'}.weight")[0]
    return ProtT5Config(name=name, vocab_size=vocab, d_model=d_model, d_kv=inner // h,
                        num_heads=h, num_layers=_block_count(sd, "encoder.block."), d_ff=d_ff,
                        num_buckets=nb, gated=gated)


def is_tied(sd: Mapping) -> bool:
    """A tied head: no ``lm_head.weight``, or one equal to ``shared.weight``
    (a tied HF state dict still holds it; the JAX converter compares the
    values, and so does this)."""
    if "lm_head.weight" not in sd:
        return True
    a, b = sd["lm_head.weight"], sd["shared.weight"]
    if torch.is_tensor(a) and torch.is_tensor(b):
        return a.shape == b.shape and bool(torch.equal(a, b.to(a.device)))
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


def _empty_model(config: ProtT5Config, decoder_layers: int, tied: bool, device) -> ProtT5:
    with torch.device("meta"):
        model = ProtT5(config, decoder_layers, tied)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


def load_state_dict(sd: Mapping, config: Optional[ProtT5Config] = None,
                    device="cuda") -> ProtT5:
    """The model from an HF ``T5EncoderModel`` or
    ``T5ForConditionalGeneration`` state dict (tensors or numpy arrays), the
    decoder and a tied or untied head found from its keys and values."""
    config = config or config_from_state_dict(sd)
    n_dec = _block_count(sd, "decoder.block.") if "decoder.final_layer_norm.weight" in sd else 0
    model = _empty_model(config, n_dec, is_tied(sd), device)
    return copy_state_dict(model, sd, config.name)


@torch.no_grad()
def init_random(config: ProtT5Config, seed: int = 0, device="cuda", decoder_layers: int = 0,
                tied: bool = True) -> ProtT5:
    """Seeded random weights with the JAX ``init_params`` distributions (the
    draws differ): projections N(0, 1/d_in), the embedding N(0, 1), the
    relative bias N(0, 0.01), unit norms."""
    model = _empty_model(config, decoder_layers, tied, device)
    dev = model.shared.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("layer_norm.weight"):
            p.fill_(1.0)
            continue
        draw = torch.randn(tuple(p.shape), generator=gen, device=dev)
        if name.endswith("relative_attention_bias.weight"):
            draw = draw * 0.1
        elif p.dim() == 2 and name != "shared.weight":
            draw = draw / math.sqrt(p.shape[1])
        p.copy_(draw)
    return model


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX params pytree (numpy leaves) as an HF-named state dict (a tied
    head when the JAX decoder has no ``lm_head``)."""
    sd: Dict[str, torch.Tensor] = {}

    def put(key, value, transpose=False):
        arr = np.array(value, np.float32)
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr.T if transpose else arr))

    def proj(prefix, p):
        for n in ("q", "k", "v", "o"):
            put(f"{prefix}.{n}.weight", p[n], True)

    def ffn(prefix, layer):
        for n in ("wi", "wi_0", "wi_1", "wo"):
            if n in layer:
                put(f"{prefix}.DenseReluDense.{n}.weight", layer[n], True)

    put("shared.weight", params["embed"])
    put("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
        params["rel_bias"])
    for i, layer in enumerate(params["layers"]):
        p = f"encoder.block.{i}.layer"
        proj(f"{p}.0.SelfAttention", layer)
        put(f"{p}.0.layer_norm.weight", layer["ln_attn"])
        ffn(f"{p}.1", layer)
        put(f"{p}.1.layer_norm.weight", layer["ln_ff"])
    put("encoder.final_layer_norm.weight", params["final_ln"])
    dec = params.get("decoder")
    if dec is not None:
        put("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight",
            dec["rel_bias"])
        for i, layer in enumerate(dec["layers"]):
            p = f"decoder.block.{i}.layer"
            proj(f"{p}.0.SelfAttention", layer["self"])
            put(f"{p}.0.layer_norm.weight", layer["ln_self"])
            proj(f"{p}.1.EncDecAttention", layer["cross"])
            put(f"{p}.1.layer_norm.weight", layer["ln_cross"])
            ffn(f"{p}.2", layer)
            put(f"{p}.2.layer_norm.weight", layer["ln_ff"])
        put("decoder.final_layer_norm.weight", dec["final_ln"])
        if dec.get("lm_head") is not None:
            put("lm_head.weight", dec["lm_head"], True)
    return sd
