"""ProGen2 (salesforce/progen): weights from the seed in the published
names, the port's model built through its own loader, the plain float32
reference, and the operations of a forward.

The reference follows ``modeling_progen.py``: GPT-J's parallel block
(one ``ln_1`` feeding attention and MLP, both added to the residual), the
bias-free fused qkv projection in ``mp_num`` shards split q, v, k, the
interleaved ("rotate_every_two") rotary on each head's first
``rotary_dim`` dims, causal float32 attention scaled by sqrt(head_dim),
the tanh GELU, ``ln_f`` and the lm_head with its bias. Scoring reads the
logits of the 25 letter tokens (ids 5..29). It imports nothing of the
port; each layer's weights are cast to float32 as it runs.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.precision import Precision, full_float32

LETTERS = "ABCDEFGHIKLMNOPQRSTUVWXYZ"  # the harness's alphabet, token ids 5..29
FIRST_LETTER_ID = 5
_INDEX = {c: i for i, c in enumerate(LETTERS)}


def tokenize(seq: str) -> np.ndarray:
    """Letters onto their index in ``LETTERS``, unknown letters as X: a copy
    of the port scorer's ``_letters`` tokenizer for ProGen2."""
    return np.asarray([_INDEX.get(c, _INDEX["X"]) for c in seq], np.int64)


PAD_ID = _INDEX["X"]


def weight_specs(cfg: dict) -> List[Tuple[str, tuple, str, str]]:
    d, f, v = cfg["embed_dim"], cfg["ffn_dim"], cfg["vocab_size"]
    w = cfg["precision"]["weights"]
    specs = [("transformer.wte.weight", (v, d), w, "embed")]
    for i in range(cfg["num_layers"]):
        p = f"transformer.h.{i}"
        specs += [(f"{p}.ln_1.weight", (d,), "float32", "ln_weight"),
                  (f"{p}.ln_1.bias", (d,), "float32", "ln_bias"),
                  (f"{p}.attn.qkv_proj.weight", (3 * d, d), w, "dense"),
                  (f"{p}.attn.out_proj.weight", (d, d), w, "dense"),
                  (f"{p}.mlp.fc_in.weight", (f, d), w, "dense"),
                  (f"{p}.mlp.fc_in.bias", (f,), "float32", "bias"),
                  (f"{p}.mlp.fc_out.weight", (d, f), w, "dense"),
                  (f"{p}.mlp.fc_out.bias", (d,), "float32", "bias")]
    specs += [("transformer.ln_f.weight", (d,), "float32", "ln_weight"),
              ("transformer.ln_f.bias", (d,), "float32", "ln_bias"),
              ("lm_head.weight", (v, d), "float32", "dense"),
              ("lm_head.bias", (v,), "float32", "bias")]
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    from h100bench.weights import draw

    return draw(weight_specs(cfg), cfg["init"], seed, device)


@dataclasses.dataclass
class Program:
    model: torch.nn.Module
    logits_fn: object
    attention: Tuple[object, str, str]
    n_ctx: int
    tokenize: object
    pad_id: int


def port_config(cfg: dict):
    from proteingym_tpu_torch.models import ar_zoo

    conf = ar_zoo.ProGen2Config(
        name=cfg["model"], num_layers=cfg["num_layers"], embed_dim=cfg["embed_dim"],
        num_heads=cfg["num_heads"], rotary_dim=cfg["rotary_dim"], vocab_size=cfg["vocab_size"],
        n_ctx=cfg["n_ctx"], mp_num=cfg["mp_num"],
        dtype={"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["precision"]["weights"]])
    if 4 * conf.embed_dim != cfg["ffn_dim"]:
        raise ValueError(f"the port's ProGen2 has ffn {4 * conf.embed_dim}, "
                         f"the configuration {cfg['ffn_dim']}")
    return conf


def build(cfg: dict, weights: Dict[str, torch.Tensor], device) -> Program:
    """The port's ``ProGen2`` through ``ar_zoo.progen2_load_state_dict``;
    the harness scores its ``restricted_logits``."""
    from proteingym_tpu_torch.models import ar_zoo

    model = ar_zoo.progen2_load_state_dict(weights, port_config(cfg), device=device)
    return Program(model=model, logits_fn=model.restricted_logits,
                   attention=(ar_zoo, "mha", "bhtd"), n_ctx=cfg["n_ctx"],
                   tokenize=tokenize, pad_id=PAD_ID)


def _rotate_every_two(x):
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).flatten(-2)


class Reference:
    """ProGen2's forward in plain float32 PyTorch (TF32 off), a layer's
    weights cast to float32 as it runs; ``precision`` rounds the products'
    operands for the control."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device,
                 precision: Precision = None, block: int = 32):
        self.cfg, self.w = cfg, weights
        self.device = torch.device(device)
        self.prec = precision or Precision()
        self.block = block

    def _f32(self, name):
        return self.w[name].float()

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self._f32(f"{name}.weight"),
                            self._f32(f"{name}.bias"), self.cfg["layer_norm_eps"])

    @torch.no_grad()
    def letter_logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) harness letter ids -> (B, T, 25) float32 logits of the
        letter tokens."""
        cfg, prec = self.cfg, self.prec
        with full_float32():
            b, t = tokens.shape
            d, h_n, rd = cfg["embed_dim"], cfg["num_heads"], cfg["rotary_dim"]
            hd, mp = d // h_n, cfg["mp_num"]
            ids = tokens + FIRST_LETTER_ID
            x = self._f32("transformer.wte.weight")[ids]
            inv = 1.0 / (10000 ** (np.arange(0, rd, 2, dtype=np.float64) / rd))
            ang = np.repeat(np.outer(np.arange(t, dtype=np.float64), inv), 2, axis=-1)
            cos = torch.as_tensor(np.cos(ang), dtype=torch.float32, device=tokens.device)
            sin = torch.as_tensor(np.sin(ang), dtype=torch.float32, device=tokens.device)
            causal = torch.ones(t, t, dtype=torch.bool, device=tokens.device).tril()
            for i in range(cfg["num_layers"]):
                p = f"transformer.h.{i}"
                y = self._ln(x, f"{p}.ln_1")
                qkv = prec.linear(y, self._f32(f"{p}.attn.qkv_proj.weight"))
                qkv = qkv.view(b, t, mp, -1)
                q, v, k = (z.reshape(b, t, h_n, hd) for z in qkv.chunk(3, dim=-1))

                def rope(z):
                    head = z[..., :rd]
                    rotated = head * cos[None, :, None] + _rotate_every_two(head) * sin[None, :, None]
                    return torch.cat([rotated, z[..., rd:]], dim=-1).transpose(1, 2)

                q, k, v = rope(q), rope(k), v.transpose(1, 2)
                scores = prec.mm("attention", q, k.transpose(-1, -2)) / math.sqrt(hd)
                scores = scores.masked_fill(~causal, float("-inf"))
                ctx = prec.mm("attention", torch.softmax(scores, dim=-1), v)
                attn = prec.linear(ctx.transpose(1, 2).reshape(b, t, d),
                                   self._f32(f"{p}.attn.out_proj.weight"))
                hidden = F.gelu(prec.linear(y, self._f32(f"{p}.mlp.fc_in.weight"),
                                            self._f32(f"{p}.mlp.fc_in.bias")), approximate="tanh")
                mlp = prec.linear(hidden, self._f32(f"{p}.mlp.fc_out.weight"),
                                  self._f32(f"{p}.mlp.fc_out.bias"))
                x = x + attn + mlp
            x = self._ln(x, "transformer.ln_f")
            logits = prec.linear(x, self._f32("lm_head.weight"), self._f32("lm_head.bias"),
                                 kind="head")
            return logits[..., FIRST_LETTER_ID:FIRST_LETTER_ID + len(LETTERS)]

    def loglik(self, rows: Sequence[np.ndarray]) -> np.ndarray:
        """Each row's sum over t >= 1 of log p(x_t | x_<t), float64; rows of
        one length run ``block`` at a time."""
        out = np.zeros(len(rows))
        by_len: Dict[int, List[int]] = {}
        for i, r in enumerate(rows):
            by_len.setdefault(len(r), []).append(i)
        for n, idx in by_len.items():
            if n < 2:
                continue
            for b0 in range(0, len(idx), self.block):
                part = idx[b0:b0 + self.block]
                toks = torch.as_tensor(np.stack([rows[i] for i in part]), device=self.device)
                logp = torch.log_softmax(self.letter_logits(toks)[:, :-1], dim=-1)
                ll = logp.gather(-1, toks[:, 1:, None])[..., 0].double().sum(-1)
                out[part] = ll.cpu().numpy()
        return out


def forward_flops(cfg: dict, n: int) -> float:
    """Operations of one causal forward of one row of ``n`` tokens: qkv,
    out, fc_in and fc_out, attention's two products over the n (n + 1) / 2
    causal pairs counted as n^2 / 2, and the lm_head."""
    d, f, v, layers = cfg["embed_dim"], cfg["ffn_dim"], cfg["vocab_size"], cfg["num_layers"]
    per_layer = 2 * n * (4 * d * d + 2 * d * f) + 2 * n * n * d
    return float(layers * per_layer + 2 * n * d * v)


def forward_bytes(cfg: dict) -> float:
    total = 0
    for _, shape, dtype, _ in weight_specs(cfg):
        total += math.prod(shape) * (2 if dtype == "bfloat16" else 4)
    return float(total)
