"""ESM2 (facebookresearch/esm): weights from the seed in fair-esm's
names, the port's model built through its own loader, the plain float32
reference, and the operations of a forward.

The reference follows fair-esm's ``ESM2`` forward for rows without
padding: token dropout's rescale at inference, pre-LN blocks, q scaled
before the rotary (``rotate_half``, base 10,000), the exact-erf GELU, the
final LN and the Roberta head tied to the token embedding. It imports
nothing of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from h100bench.precision import Precision, full_float32

# fair-esm's protein alphabet (esm.data.Alphabet, "ESM-1b" order)
TOKENS = (["<cls>", "<pad>", "<eos>", "<unk>"]
          + list("LAGVSERTIDPKQNFYMHWCXBUZO.-") + ["<null_1>", "<mask>"])
INDEX = {t: i for i, t in enumerate(TOKENS)}
CLS, PAD, EOS, UNK, MASK = (INDEX[t] for t in ("<cls>", "<pad>", "<eos>", "<unk>", "<mask>"))


def tokenize(seq: str) -> np.ndarray:
    return np.asarray([CLS] + [INDEX.get(c, UNK) for c in seq] + [EOS], dtype=np.int64)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def weight_specs(cfg: dict) -> List[Tuple[str, tuple, str, str]]:
    """(name, shape, dtype, init) of every tensor, in fair-esm's names and
    a fixed order. init: ``dense`` N(0, 1/fan_in), ``embed`` N(0, std^2),
    ``bias`` / ``ln_bias`` N(0, std^2), ``ln_weight`` 1 + N(0, std^2)."""
    d, f, v = cfg["embed_dim"], cfg["ffn_dim"], cfg["alphabet_size"]
    w = cfg["precision"]["weights"]
    specs = [("embed_tokens.weight", (v, d), w, "embed")]
    for i in range(cfg["num_layers"]):
        p = f"layers.{i}"
        for proj in ("q", "k", "v", "out"):
            specs += [(f"{p}.self_attn.{proj}_proj.weight", (d, d), w, "dense"),
                      (f"{p}.self_attn.{proj}_proj.bias", (d,), w, "bias")]
        specs += [(f"{p}.fc1.weight", (f, d), w, "dense"), (f"{p}.fc1.bias", (f,), w, "bias"),
                  (f"{p}.fc2.weight", (d, f), w, "dense"), (f"{p}.fc2.bias", (d,), w, "bias")]
        for ln in ("self_attn_layer_norm", "final_layer_norm"):
            specs += [(f"{p}.{ln}.weight", (d,), "float32", "ln_weight"),
                      (f"{p}.{ln}.bias", (d,), "float32", "ln_bias")]
    specs += [("emb_layer_norm_after.weight", (d,), "float32", "ln_weight"),
              ("emb_layer_norm_after.bias", (d,), "float32", "ln_bias"),
              ("lm_head.dense.weight", (d, d), w, "dense"),
              ("lm_head.dense.bias", (d,), w, "bias"),
              ("lm_head.layer_norm.weight", (d,), "float32", "ln_weight"),
              ("lm_head.layer_norm.bias", (d,), "float32", "ln_bias"),
              ("lm_head.bias", (v,), "float32", "bias")]
    return specs


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict drawn from ``seed`` on ``device``: one draw for each
    (dtype, kind of init), in the served dtype, split into views."""
    from h100bench.weights import draw

    weights = draw(weight_specs(cfg), cfg["init"], seed, device)
    weights["lm_head.weight"] = weights["embed_tokens.weight"]  # tied, as published
    return weights


@dataclasses.dataclass
class Program:
    """The port's model and what the harness hands its entries."""
    model: torch.nn.Module
    logits_fn: object
    attention: Tuple[object, str, str]  # (module, attribute, "bthd" | "bhtd")
    window: int


def port_config(cfg: dict):
    from proteingym_tpu_torch.models import esm2 as port

    conf = port.EsmConfig(
        name=cfg["model"], num_layers=cfg["num_layers"], embed_dim=cfg["embed_dim"],
        num_heads=cfg["num_heads"], alphabet_size=cfg["alphabet_size"],
        token_dropout=cfg["token_dropout"], use_rotary=True, emb_layer_norm_before=False,
        max_positions=cfg["max_positions"], dtype=_dtype(cfg["precision"]["weights"]))
    if conf.ffn_dim != cfg["ffn_dim"]:
        raise ValueError(f"the port's ESM has ffn {conf.ffn_dim}, the configuration {cfg['ffn_dim']}")
    return conf


def build(cfg: dict, weights: Dict[str, torch.Tensor], device) -> Program:
    """The port's ``EsmModel`` from ``weights`` through
    ``esm2.load_fair_esm_state_dict``."""
    from proteingym_tpu_torch.models import esm2 as port

    model = port.load_fair_esm_state_dict(weights, port_config(cfg), device=device)
    return Program(model=model, logits_fn=model, attention=(port, "mha_natural", "bthd"),
                   window=cfg["max_positions"])


def _rotary(t: int, dim: int, base: float, device):
    inv = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    freqs = np.outer(np.arange(t, dtype=np.float64), inv)
    emb = np.concatenate([freqs, freqs], axis=-1)
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return as_t(np.cos(emb)), as_t(np.sin(emb))


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


class Reference:
    """fair-esm's ESM2 forward in plain float32 PyTorch (TF32 off), on
    ``weights`` cast to float32; ``precision`` rounds the products' operands
    for the control."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device,
                 precision: Precision = None):
        self.cfg = cfg
        self.w = {k: v.float() for k, v in weights.items()}
        self.device = torch.device(device)
        self.prec = precision or Precision()

    def _ln(self, x, name):
        return F.layer_norm(x, x.shape[-1:], self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            self.cfg["layer_norm_eps"])

    def _lin(self, x, name):
        return self.prec.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T) unpadded token rows -> (B, T, V) float32 logits."""
        cfg, w, prec = self.cfg, self.w, self.prec
        with full_float32():
            b, t = tokens.shape
            h_n, d = cfg["num_heads"], cfg["embed_dim"]
            hd = d // h_n
            x = w["embed_tokens.weight"][tokens]
            if cfg["token_dropout"]:
                masked = tokens == MASK
                x = x.masked_fill(masked[..., None], 0.0)
                ratio = masked.sum(-1).float() / t
                x = x * ((1 - 0.15 * 0.8) / (1 - ratio))[:, None, None]
            cos, sin = _rotary(t, hd, cfg["rope_base"], tokens.device)
            rot = lambda z: z * cos + _rotate_half(z) * sin
            heads = lambda z: z.view(b, t, h_n, hd).transpose(1, 2)
            for i in range(cfg["num_layers"]):
                p = f"layers.{i}"
                h = self._ln(x, f"{p}.self_attn_layer_norm")
                q = rot(heads(self._lin(h, f"{p}.self_attn.q_proj") * hd ** -0.5))
                k = rot(heads(self._lin(h, f"{p}.self_attn.k_proj")))
                v = heads(self._lin(h, f"{p}.self_attn.v_proj"))
                probs = torch.softmax(prec.mm("attention", q, k.transpose(-1, -2)), dim=-1)
                ctx = prec.mm("attention", probs, v).transpose(1, 2).reshape(b, t, d)
                x = x + self._lin(ctx, f"{p}.self_attn.out_proj")
                h = self._ln(x, f"{p}.final_layer_norm")
                x = x + self._lin(F.gelu(self._lin(h, f"{p}.fc1")), f"{p}.fc2")
            x = self._ln(x, "emb_layer_norm_after")
            h = self._ln(F.gelu(self._lin(x, "lm_head.dense")), "lm_head.layer_norm")
            return prec.mm("head", h, w["embed_tokens.weight"].t()) + w["lm_head.bias"]


def forward_flops(cfg: dict, n: int) -> float:
    """Operations of one forward of one row of ``n`` tokens: the layers'
    products (q, k, v, out, fc1, fc2), attention's two products over all
    n x n pairs, the head's dense and its logits."""
    d, f, v, layers = cfg["embed_dim"], cfg["ffn_dim"], cfg["alphabet_size"], cfg["num_layers"]
    per_layer = 2 * n * (4 * d * d + 2 * d * f) + 4 * n * n * d
    return float(layers * per_layer + 2 * n * d * d + 2 * n * d * v)


def forward_bytes(cfg: dict) -> float:
    """Bytes a forward must read at least: every weight once, in its
    served dtype."""
    total = 0
    for _, shape, dtype, _ in weight_specs(cfg):
        total += math.prod(shape) * (2 if dtype == "bfloat16" else 4)
    return float(total)
