"""Precision of the plain reference's products, and of its control.

The reference computes every product in float32 with TF32 off. Its
control is the same code with each product's operands rounded to the
nearest precision below the one the configuration states (``control`` in
the configuration file): ``fp8`` (float8 e4m3 with one amax scale per
tensor, as an fp8 GEMM takes them), ``tf32`` (10 mantissa bits, round to
nearest even) or ``bf16``; ``none`` leaves an operand as it is. The sums
stay in float32, as the tensor cores keep them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.abs().amax().float().clamp(min=1e-30) / FP8_MAX
    return (x.float() / scale).to(torch.float8_e4m3fn).float() * scale


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


ROUNDING = {"none": lambda x: x.float(), "fp8": round_fp8, "tf32": round_tf32,
            "bf16": round_bf16}


class Precision:
    """How the reference rounds the operands of each kind of product:
    ``dense`` (the layers' weights and activations), ``attention`` (the
    score and value products) and ``head`` (the logits' product). The
    default, and ``Precision.from_config(cfg, control=False)``, rounds
    nothing."""

    KINDS = ("dense", "attention", "head")

    def __init__(self, rounding: Optional[Dict[str, str]] = None):
        rounding = dict(rounding or {})
        unknown = set(rounding) - set(self.KINDS)
        if unknown:
            raise ValueError(f"unknown kinds of product {sorted(unknown)}")
        self.names = {k: rounding.get(k, "none") for k in self.KINDS}
        self.fns = {k: ROUNDING[v] for k, v in self.names.items()}

    @classmethod
    def from_config(cls, config: dict, control: bool) -> "Precision":
        return cls(config["control"] if control else None)

    def mm(self, kind: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in float32, each operand rounded as ``kind`` says."""
        r = self.fns[kind]
        return torch.matmul(r(a), r(b))

    def linear(self, x, weight, bias=None, kind: str = "dense"):
        """x @ weight.T (+ bias), the weight in torch's (out, in) layout."""
        y = self.mm(kind, x, weight.t())
        return y if bias is None else y + bias.float()


@contextlib.contextmanager
def full_float32():
    """float32 products in full float32 inside the block (cuBLAS and cuDNN
    without TF32), the settings restored after it."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
