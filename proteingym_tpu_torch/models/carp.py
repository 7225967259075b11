"""CARP, the ByteNet dilated-convolution masked protein LM, as a PyTorch
module (counterpart of proteingym_tpu/models/carp.py; ref
proteingym/baselines/carp_mif/compute_fitness.py and the
``sequence_models`` ByteNetLM):

  token embedding -> N residual blocks, each
    LayerNorm -> GELU -> 1x1 (d -> d/2) -> LayerNorm -> GELU ->
    dilated convolution k=5, SAME padding (d/2 -> d/2) ->
    LayerNorm -> GELU -> 1x1 (d/2 -> d)
  with dilations 1, 2, 4, ..., 128 repeating; a final LayerNorm and the
  vocabulary head. The convolutions are not causal (CARP is a masked LM).

The module holds the zenodo ``carp_*.pt`` layout by name
(``embedder.embedder``, an optional ``embedder.up_embedder``,
``embedder.layers.N.{sequence1, conv, sequence2}``, an optional
``last_norm``, ``decoder``), so a published state dict loads natively.
As the JAX converter does, each block's ``sequence1`` / ``sequence2`` op
program is read from the file's own parameter shapes: a 1-D weight is a
LayerNorm followed by the block's GELU, a 3-D (out, in, 1) or 2-D weight a
position-wise feed-forward. A preset's random weights take the program of
the JAX ``apply``: [LN, 1x1 down, LN] / [LN, 1x1 up].

Numerics follow the JAX ``apply``: layer norms with float32 statistics,
rounded to the model dtype; the tanh GELU (``jax.nn.gelu``'s default) in
float32, rounded to the model dtype; each feed-forward a product in the
model dtype rounded to it, plus the float32 bias, rounded again (the JAX
``_dense``); the dilated convolution in float32 (``F.conv1d``, without
TF32 on the card), rounded once after its bias; the head in float32. The
JAX ``apply_converted`` promotes the stream to float32 at the first
feed-forward with a bias, which a published file's blocks have, so a
published file runs here in float32.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from proteingym_tpu_torch.devices import resolve_device
from proteingym_tpu_torch.models.ar_zoo import matmul_f32
from proteingym_tpu_torch.models.esm2 import LayerNorm, copy_state_dict

# sequence_models.constants: CAN_AAS + AMB_AAS + OTHER_AAS + specials
CARP_ALPHABET = list("ACDEFGHIKLMNPQRSTVWYBZXJOU") + ["-", "*", "#", "@"]
CARP_MASK_IDX = CARP_ALPHABET.index("#")
CARP_PAD_IDX = CARP_ALPHABET.index("-")


class CarpTokenizer:
    mask_idx = CARP_MASK_IDX
    pad_idx = CARP_PAD_IDX

    def __init__(self):
        self.tok_to_idx = {t: i for i, t in enumerate(CARP_ALPHABET)}

    def get_idx(self, c: str) -> int:
        return self.tok_to_idx.get(c, self.tok_to_idx["X"])

    def encode(self, seq: str) -> np.ndarray:
        return np.asarray([self.get_idx(c) for c in seq], dtype=np.int32)


@dataclasses.dataclass(frozen=True)
class CarpConfig:
    name: str = "carp_640M"
    num_layers: int = 56
    embed_dim: int = 1280
    kernel_size: int = 5
    max_dilation: int = 128
    vocab_size: int = 30
    dtype: torch.dtype = torch.bfloat16


CARP_PRESETS = {
    "carp_600k": CarpConfig("carp_600k", 16, 128),
    "carp_38M": CarpConfig("carp_38M", 16, 1024),
    "carp_76M": CarpConfig("carp_76M", 32, 1024),
    "carp_640M": CarpConfig("carp_640M", 56, 1280),
}


def _dilation_schedule(c: CarpConfig):
    out = []
    d = 1
    for _ in range(c.num_layers):
        out.append(d)
        d *= 2
        if d > c.max_dilation:
            d = 1
    return out


class LnGelu(LayerNorm):
    """A LayerNorm and the block's tanh GELU after it, in float32, rounded
    to the input dtype."""

    def forward(self, x):
        return F.gelu(super().forward(x).float(), approximate="tanh").to(x.dtype)


class FeedForward(nn.Module):
    """A position-wise feed-forward (the 1x1 convolution), weight (out, in)
    in the model dtype: the product rounded to the input dtype, the
    float32 bias added, rounded again."""

    def __init__(self, n_in: int, n_out: int, dtype, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_out, n_in, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(n_out)) if bias else None

    def forward(self, x):
        y = matmul_f32(x, self.weight.t()).to(x.dtype)
        return y if self.bias is None else (y + self.bias).to(x.dtype)


class Conv(nn.Module):
    """``conv``: the dilated convolution, (out, in, k) float32 weight, SAME
    padding, run in float32 and rounded once after its bias."""

    def __init__(self, channels: int, kernel_size: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.weight = nn.Parameter(torch.empty(channels, channels, kernel_size))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):  # (B, T, C)
        pad = self.dilation * (self.weight.shape[-1] - 1) // 2
        y = F.conv1d(x.float().transpose(1, 2), self.weight, self.bias, padding=pad,
                     dilation=self.dilation)
        return y.transpose(1, 2).to(x.dtype)


class ConvHolder(nn.Module):
    """Names the convolution ``conv.conv`` as the zenodo file does."""

    def __init__(self, conv: Conv):
        super().__init__()
        self.conv = conv


# an op program: ("ln", dim) or ("ff", n_in, n_out, bias)
Program = List[Tuple]


class ByteNetBlock(nn.Module):
    def __init__(self, pre: Program, post: Program, channels: int, kernel_size: int,
                 dilation: int, dtype):
        super().__init__()
        self.sequence1 = _ops(pre, dtype)
        self.conv = ConvHolder(Conv(channels, kernel_size, dilation))
        self.sequence2 = _ops(post, dtype)

    def forward(self, x):
        return x + self.sequence2(self.conv.conv(self.sequence1(x)))


def _ops(program: Program, dtype) -> nn.Sequential:
    """The program as a Sequential whose indices are the zenodo file's: a
    LayerNorm at i, its GELU at i + 1 (no parameters, so an Identity
    here), a feed-forward at i."""
    seq = nn.Sequential()
    for op in program:
        if op[0] == "ln":
            seq.append(LnGelu(op[1]))
            seq.append(nn.Identity())
        else:
            seq.append(FeedForward(op[1], op[2], dtype, bias=op[3]))
    return seq


class Embedder(nn.Module):
    def __init__(self, vocab: int, d_embedding: int, d_model: int, up: bool, blocks, dtype):
        super().__init__()
        self.embedder = nn.Embedding(vocab, d_embedding, dtype=dtype)
        if up:
            self.up_embedder = ConvHolder(FeedForward(d_embedding, d_model, dtype))
        self.layers = nn.ModuleList(blocks)


@dataclasses.dataclass(frozen=True)
class Layout:
    """The shapes a model is built with: the embedding width, each block's
    op programs, the convolutions' channels, and whether there is an
    up-embedder, a final LayerNorm and a head bias."""

    d_embedding: int
    programs: Tuple[Tuple[Program, Program], ...]
    channels: int
    up_embedder: bool = False
    last_norm: bool = True
    decoder_bias: bool = True


def native_layout(c: CarpConfig) -> Layout:
    """The JAX ``apply``'s program: [LN, down, LN] / [LN, up], no up-embedder."""
    d, dh = c.embed_dim, c.embed_dim // 2
    block = ([("ln", d), ("ff", d, dh, True), ("ln", dh)], [("ln", dh), ("ff", dh, d, True)])
    return Layout(d, (block,) * c.num_layers, dh)


class Carp(nn.Module):
    """(B, T) tokens -> (B, T, V) float32 logits."""

    def __init__(self, config: CarpConfig, layout: Layout):
        super().__init__()
        self.config = config
        d = config.embed_dim
        sched = _dilation_schedule(dataclasses.replace(config, num_layers=len(layout.programs)))
        blocks = [ByteNetBlock(pre, post, layout.channels, config.kernel_size, dil, config.dtype)
                  for (pre, post), dil in zip(layout.programs, sched)]
        self.embedder = Embedder(config.vocab_size, layout.d_embedding, d, layout.up_embedder,
                                 blocks, config.dtype)
        if layout.last_norm:
            self.last_norm = LayerNorm(d)
        self.decoder = ConvHolder(FeedForward(d, config.vocab_size, torch.float32,
                                              bias=layout.decoder_bias))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embedder.embedder(tokens)
        if hasattr(self.embedder, "up_embedder"):
            x = self.embedder.up_embedder.conv(x)
        for block in self.embedder.layers:
            x = block(x)
        if hasattr(self, "last_norm"):
            x = self.last_norm(x)
        return self.decoder.conv(x.float())


def _empty_carp(config: CarpConfig, layout: Layout, device) -> Carp:
    with torch.device("meta"):
        model = Carp(config, layout)
    return model.to_empty(device=resolve_device(device)).eval().requires_grad_(False)


@torch.no_grad()
def init_random(config: CarpConfig, seed: int = 0, device="cuda") -> Carp:
    """Seeded random weights with the JAX ``init_params`` distribution (the
    draws differ): the embedding N(0, 0.02^2), each feed-forward and the
    head N(0, 2 / n_in), each convolution N(0, 2 / (k d/2)), zero biases,
    unit layer-norm scales."""
    model = _empty_carp(config, native_layout(config), device)
    dev = model.decoder.conv.weight.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            continue
        if isinstance(m, nn.Embedding):
            w, std = m.weight, 0.02
        elif isinstance(m, (FeedForward, Conv)):
            w = m.weight
            std = float(np.sqrt(2.0 / (w.shape[1] * (w.shape[2] if w.dim() == 3 else 1))))
            m.bias.zero_()
        else:
            continue
        for chunk in w.view(-1, w.shape[-1]).split(4096):
            chunk.copy_(torch.randn(tuple(chunk.shape), generator=gen, device=dev) * std)
    return model


def _seq_ops(sd: Mapping, prefix: str) -> Tuple[Program, Dict]:
    """A zenodo Sequential's op program and its state entries, renamed to
    the module's: the kind of each op read from its weight's shape."""
    idxs = sorted({int(m.group(1)) for k in sd
                   if (m := re.match(rf"{re.escape(prefix)}\.(\d+)\.", k))})
    program, entries, at = [], {}, 0
    for j in idxs:
        wk = next((c for c in (f"{prefix}.{j}.weight", f"{prefix}.{j}.conv.weight") if c in sd),
                  None)
        if wk is None:
            continue
        w = torch.as_tensor(np.asarray(sd[wk], np.float32))
        bk = wk.replace("weight", "bias")
        if w.dim() == 1:
            program.append(("ln", w.shape[0]))
            entries[f"{at}.weight"] = w
            entries[f"{at}.bias"] = sd[bk] if bk in sd else torch.zeros_like(w)
            at += 2
        elif w.dim() == 2 or (w.dim() == 3 and w.shape[-1] == 1):
            w = w.reshape(w.shape[0], w.shape[1])
            program.append(("ff", w.shape[1], w.shape[0], bk in sd))
            entries[f"{at}.weight"] = w
            if bk in sd:
                entries[f"{at}.bias"] = sd[bk]
            at += 1
        else:
            raise ValueError(f"unexpected parameter shape {tuple(w.shape)} at {wk}")
    return program, entries


def _first(sd: Mapping, *keys):
    return next((k for k in keys if k in sd), None)


def _as_2d(x) -> torch.Tensor:
    w = torch.as_tensor(np.asarray(x, np.float32))
    return w.reshape(w.shape[0], w.shape[1])


def convert_torch_state_dict(state_dict: Mapping, config: CarpConfig,
                             device="cuda") -> Carp:
    """The model from a zenodo ``carp_*.pt`` ``model_state_dict`` (tensors or
    numpy arrays, with or without a ``module.`` prefix). The number of
    blocks, their op programs and the embedding width come from the file;
    ``config`` gives the dtype, kernel size and dilation schedule."""
    sd = {k.removeprefix("module."): v for k, v in state_dict.items()}
    n_layers = 1 + max(int(m.group(1)) for k in sd
                       if (m := re.match(r"embedder\.layers\.(\d+)\.", k)))
    out = {"embedder.embedder.weight": sd["embedder.embedder.weight"]}
    up = _first(sd, "embedder.up_embedder.conv.weight", "embedder.up_embedder.weight")
    if up is not None:
        out["embedder.up_embedder.conv.weight"] = _as_2d(sd[up])
        up_b = up.replace("weight", "bias")
        out["embedder.up_embedder.conv.bias"] = (sd[up_b] if up_b in sd
                                                 else torch.zeros(out[
                                                     "embedder.up_embedder.conv.weight"].shape[0]))
    programs = []
    for i in range(n_layers):
        base = f"embedder.layers.{i}"
        pre, pre_sd = _seq_ops(sd, f"{base}.sequence1")
        post, post_sd = _seq_ops(sd, f"{base}.sequence2")
        programs.append((pre, post))
        out.update({f"{base}.sequence1.{k}": v for k, v in pre_sd.items()})
        out.update({f"{base}.sequence2.{k}": v for k, v in post_sd.items()})
        conv = _first(sd, f"{base}.conv.conv.weight", f"{base}.conv.weight")
        if conv is None:
            raise KeyError(f"no conv weight under {base}")
        out[f"{base}.conv.conv.weight"] = sd[conv]
        conv_b = conv.replace("weight", "bias")
        out[f"{base}.conv.conv.bias"] = (sd[conv_b] if conv_b in sd
                                         else torch.zeros(np.asarray(sd[conv]).shape[0]))
    if "last_norm.weight" in sd:
        out["last_norm.weight"], out["last_norm.bias"] = sd["last_norm.weight"], sd["last_norm.bias"]
    dec = _first(sd, "decoder.conv.weight", "decoder.weight")
    out["decoder.conv.weight"] = _as_2d(sd[dec])
    dec_b = dec.replace("weight", "bias")
    if dec_b in sd:
        out["decoder.conv.bias"] = sd[dec_b]
    emb = np.asarray(sd["embedder.embedder.weight"])
    layout = Layout(emb.shape[1], tuple(programs),
                    channels=int(np.asarray(out["embedder.layers.0.conv.conv.weight"]).shape[0]),
                    up_embedder=up is not None, last_norm="last_norm.weight" in sd,
                    decoder_bias=dec_b in sd)
    if up is None and emb.shape[1] != config.embed_dim:
        raise ValueError(f"embedding width {emb.shape[1]} without an up-embedder, "
                         f"config width {config.embed_dim}")
    model = _empty_carp(config, layout, device)
    return copy_state_dict(model, out, config.name)


def params_from_jax(params, config: CarpConfig) -> Dict[str, torch.Tensor]:
    """The JAX ``init_params`` pytree (numpy leaves) in the zenodo names of
    ``native_layout``, which ``convert_torch_state_dict`` reads (as it
    reads ``Carp.state_dict()``): (in, out) matrices as (out, in), the
    (k, in, out) convolution as (out, in, k)."""
    a = lambda x: torch.from_numpy(np.array(x, dtype=np.float32))
    t = lambda x: a(np.asarray(x).T)
    sd = {"embedder.embedder.weight": a(params["embed"]),
          "last_norm.weight": a(params["final_ln"]["g"]),
          "last_norm.bias": a(params["final_ln"]["b"]),
          "decoder.conv.weight": t(params["head"]["w"]),
          "decoder.conv.bias": a(params["head"]["b"])}
    for i, layer in enumerate(params["layers"][:config.num_layers]):
        p = f"embedder.layers.{i}"
        for name, key in (("sequence1.0", "ln1"), ("sequence1.3", "ln2"), ("sequence2.0", "ln3")):
            sd[f"{p}.{name}.weight"] = a(layer[key]["g"])
            sd[f"{p}.{name}.bias"] = a(layer[key]["b"])
        for name, key in (("sequence1.2", "down"), ("sequence2.2", "up")):
            sd[f"{p}.{name}.weight"] = t(layer[key]["w"])
            sd[f"{p}.{name}.bias"] = a(layer[key]["b"])
        sd[f"{p}.conv.conv.weight"] = a(np.transpose(np.asarray(layer["conv"]["w"]), (2, 1, 0)))
        sd[f"{p}.conv.conv.bias"] = a(layer["conv"]["b"])
    return sd


def score_assay(
    model: Carp,
    sequence: str,
    mutants: Sequence[str],
    strategy: str = "masked-marginals",
    chunk: int = 16,
    offset_idx: int = 1,
) -> np.ndarray:
    """Marginal scores (ref compute_fitness.py label_row): the sum over a
    mutant's positions of log p(mt) - log p(wt), from a WT forward or one
    masked row per position (no special tokens, no window), divided by
    the number of mutated positions. A literal WT row raises, as in the
    JAX function."""
    from proteingym_tpu_torch.models.esm_scoring import masked_marginal_table, wt_marginal_table

    tok = CarpTokenizer()
    tokens = tok.encode(sequence)
    if strategy == "wt-marginals":
        table = wt_marginal_table(model, tokens)
    else:
        table = masked_marginal_table(model, tokens, mask_idx=tok.mask_idx, chunk=chunk,
                                      window=len(tokens))
    table = table.cpu().numpy()
    out = np.zeros(len(mutants))
    for i, m in enumerate(mutants):
        toks = m.split(":")
        for t in toks:
            wt, pos, mt = t[0], int(t[1:-1]) - offset_idx, t[-1]
            if sequence[pos] != wt:
                raise ValueError(f"WT mismatch in {t}")
            out[i] += table[pos, tok.get_idx(mt)] - table[pos, tok.get_idx(wt)]
        out[i] /= len(toks)  # ref label_row averages over positions
    return out
