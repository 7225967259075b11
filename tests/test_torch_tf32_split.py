"""The float32 attention kernel's arithmetic, emulated on the CPU: the 3xTF32
split that its tensor-core products use, against one TF32 pass and float64.

The kernel (``grouped_attention_f32_kernel`` in
``proteingym_tpu_torch/ops/csrc/grouped_attention.cuh``) runs only on the
card. It splits every float32 operand x of both products (q.k^T and p.v,
p the float32 softmax weights) into hi = cvt.rna.tf32(x) and
lo = cvt.rna.tf32(x - hi), and takes each product a.b as
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on mma.sync m16n8k8 (TF32 operands,
float32 sums, 8 terms an instruction). Here ``tf32_rna`` rounds the low 13
mantissa bits to nearest, ties away from zero, as the PTX instruction does,
and ``tf32_matmul`` adds each 8-term step's exact products (float64) to a
float32 accumulator, the small terms first. The attention around it is the
kernel's: q scaled in float32, the masks, a float32 softmax, the
normalisation after the value product.

Both the 3xTF32 and the 1xTF32 attention are held against float64 on
seeded inputs at the AR zoo's head dims, causal, T = 256: 3xTF32 within the
1e-4 the card's kernel is held to (``TOL`` in test_torch_cuda_kernels.py,
``F32_ATOL`` in chip_smoke.py), one TF32 pass at least 10x further off.
"""

import math

import numpy as np
import pytest
import torch

from proteingym_tpu_torch.ops import flash_attention as fa

T = 256
KERNEL_ATOL = 1e-4  # the card's float32 tolerance (TOL, F32_ATOL)
STEP = 8  # terms an mma.sync m16n8k8 adds at once


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: float32 with its low 13 mantissa bits rounded off,
    to nearest, ties away from zero (adding half an ulp to the magnitude
    bits, whose carry may reach the exponent)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x.float() - hi)  # x - hi is exact in float32


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b for float32 (..., M, K) and (..., K, N) as the tensor cores take
    it: ``passes`` 3 is a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, 1 is a_hi.b_hi
    alone. Each K step of 8 adds its exact products to a float32 sum."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    terms = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if passes == 3 else [(a_hi, b_hi)]
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], STEP):
        for x, y in terms:
            step = torch.matmul(x[..., k0:k0 + STEP].double(), y[..., k0:k0 + STEP, :].double())
            acc = (acc.double() + step).float()
    return acc


def emulated_attention(q, k, v, causal, passes):
    """softmax(q.k^T * scale [causal]) . v with both products in TF32
    (``passes`` 3 or 1) and the softmax in float32, as the kernel does it:
    q scaled first, the probabilities left unnormalised for the value
    product, the denominator floored at 1e-30 and applied after."""
    q = q * np.float32(1.0 / math.sqrt(q.shape[-1]))
    s = tf32_matmul(q, k.transpose(-1, -2), passes)
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), fa.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return tf32_matmul(p, v, passes) / den


def attention64(q, k, v, causal):
    q, k, v = (x.double() for x in (q, k, v))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool).triu(1), -math.inf)
    return torch.softmax(s, dim=-1) @ v


def _qkv(seed, d, h=2):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, h, T, d)).astype(np.float32))
            for _ in range(3)]


def test_tf32_rna_rounds_to_nearest_ties_away_from_zero():
    ulp = 2.0 ** -10  # TF32's spacing in [1, 2)
    x = torch.tensor([1.0, 1.0 + ulp / 2, 1.0 + ulp / 2 - 2.0 ** -23, 1.0 + 3 * ulp / 2,
                      -(1.0 + ulp / 2), 1.0 + ulp / 4, 2.0 - ulp / 2], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + ulp, 1.0, 1.0 + 2 * ulp, -(1.0 + ulp), 1.0, 2.0],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    # hi keeps 10 mantissa bits; hi + lo recovers x to ~2^-22 relative
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi, lo = split_tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((hi.double() + lo.double() - x.double()).abs() / x.abs().double()).max()) < 2.0 ** -21


@pytest.mark.parametrize("d", [64, 96, 128, 256])  # ProtGPT2, ProGen3, RITA_xl, ProGen2
def test_matmul_split_keeps_float32_accuracy(d):
    rng = np.random.default_rng(d)
    a, b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for shape in ((64, d), (d, 48)))
    want = a.double() @ b.double()
    scale = want.abs().max()
    err3 = float((tf32_matmul(a, b, 3).double() - want).abs().max() / scale)
    err1 = float((tf32_matmul(a, b, 1).double() - want).abs().max() / scale)
    err32 = float(((a @ b).double() - want).abs().max() / scale)
    assert err3 < 8 * max(err32, 2.0 ** -24)
    assert err1 > 100 * err3


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", [64, 96, 128, 256])  # ProtGPT2, ProGen3, RITA_xl, ProGen2
def test_three_pass_attention_holds_the_kernel_tolerance(d, causal):
    q, k, v = _qkv(d, d)
    want = attention64(q, k, v, causal)
    err3 = float((emulated_attention(q, k, v, causal, 3).double() - want).abs().max())
    err1 = float((emulated_attention(q, k, v, causal, 1).double() - want).abs().max())
    assert err3 < KERNEL_ATOL
    assert err1 >= 10 * err3
    # one TF32 pass alone already misses the kernel's tolerance
    assert err1 > KERNEL_ATOL


def test_three_pass_attention_matches_the_plain_float32_version():
    # the contract the card holds the kernel to: the plain version, in
    # float32, within TOL (atol and rtol 1e-4), here at D = 160 with the
    # plain version's own causal mask and scale
    q, k, v = _qkv(7, 160)
    got = emulated_attention(q, k, v, True, 3)
    want = fa.plain_mha(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=KERNEL_ATOL, rtol=KERNEL_ATOL)
