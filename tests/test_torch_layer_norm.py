"""The layer-norm kernel (``ops/layer_norm.py`` over ``csrc/layer_norm.cu``)
and its dispatch in ``esm2.LayerNorm``.

On the CPU: every input that is not bfloat16 on CUDA, or that autograd
needs, takes the plain version and launches nothing, and ESM's layer with
the fused add equals the old expression bit for bit. On the card (marker
``cuda``; skips without one): the kernel against the plain version at the
widths of the port's bf16 models, a bf16 ESM2 forward against the
plain-norm forward, the launch counts of an ESM2-650M and a ProGen2-xlarge
forward, and the launch span. The file imports neither jax nor the JAX
package:

    python -m pytest --noconftest -m cuda tests/test_torch_layer_norm.py
"""

import dataclasses
import types
from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from proteingym_tpu_torch.models import ar_zoo, esm2
from proteingym_tpu_torch.ops import layer_norm as ln
from proteingym_tpu_torch.pipeline import profiler

# the widths of the port's bf16 models: ESM2-650M, ESM2-3B, ProGen2-xlarge,
# ESM2-15B, and ESM-C's two, which are not multiples of 256
WIDTHS = (1280, 2560, 4096, 5120, 1152, 960)
# log-probs of a bf16 ESM2-650M forward, kernel vs plain norms: each of the
# 68 norms may round an element the other way (1 bf16 ulp), which the
# residual stream carries to ~1e-2 in the log-probs (as chip_smoke.py's
# TABLE_ATOL allows for the attention kernel); a wrong mean, variance or
# affine shifts them by O(1).
ESM_LOGP_ATOL = 1e-1


def _fake(requires_grad, width=64, address=256):
    """What ``takes_kernel`` reads of a bfloat16 CUDA tensor."""
    return types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16, shape=(3, width),
                                 data_ptr=lambda: address, requires_grad=requires_grad)


@pytest.mark.parametrize("case", ["cpu_bf16", "float32", "requires_grad", "rule"])
def test_plain_path_launches_nothing(case):
    before = dict(ln.LAUNCHES)
    norm = esm2.LayerNorm(64)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(64))
        norm.bias.copy_(0.1 * torch.randn(64))
    if case == "rule":  # bf16 on CUDA in 16-byte vectors: the kernel unless autograd needs a tensor
        norm.requires_grad_(False)
        assert ln.takes_kernel(_fake(False), norm.weight, norm.bias)
        with torch.no_grad():
            assert ln.takes_kernel(_fake(True), norm.weight, norm.bias, _fake(True))
        assert not ln.takes_kernel(_fake(True), norm.weight, norm.bias)
        assert not ln.takes_kernel(_fake(False), norm.weight, norm.bias, _fake(True))
        assert not ln.takes_kernel(_fake(False, width=60), norm.weight, norm.bias)
        assert not ln.takes_kernel(_fake(False, address=258), norm.weight, norm.bias)
        assert not ln.takes_kernel(_fake(False), norm.weight, norm.bias,
                                   _fake(False, address=264))
        norm.weight.requires_grad_(True)
        assert not ln.takes_kernel(_fake(False), norm.weight, norm.bias)
        return
    dtype = torch.float32 if case == "float32" else torch.bfloat16
    x, delta = (torch.randn(3, 5, 64).to(dtype) for _ in range(2))
    x.requires_grad_(case == "requires_grad")
    assert not ln.takes_kernel(x, norm.weight, norm.bias, delta)
    want = F.layer_norm(x.float(), (64,), norm.weight, norm.bias, 1e-5).to(dtype)
    assert torch.equal(norm(x), want)
    s, y = norm.add_norm(x, delta)
    assert torch.equal(s, x + delta)
    assert torch.equal(y, F.layer_norm(s.float(), (64,), norm.weight, norm.bias,
                                       1e-5).to(dtype))
    assert ln.LAUNCHES == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_esm_layer_equals_the_unfused_expression(dtype):
    config = dataclasses.replace(esm2.PRESETS["esm2_tiny"], dtype=dtype)
    layer = esm2.TransformerLayer(config).requires_grad_(False)
    gen = torch.Generator().manual_seed(1)
    for name, p in layer.named_parameters():  # norms' affine terms that show where they land
        scale = 0.1 if p.dim() == 1 else p.shape[1] ** -0.5
        p.copy_(torch.randn(p.shape, generator=gen) * scale + (name.endswith("norm.weight")))
    x = torch.randn(2, 12, config.embed_dim, generator=gen).to(dtype)
    key_mask = torch.arange(12)[None] < torch.tensor([[12], [9]])
    with torch.no_grad():
        x1 = x + layer.self_attn(layer.self_attn_layer_norm(x), key_mask)
        want = x1 + layer.fc2(F.gelu(layer.fc1(layer.final_layer_norm(x1))))
        assert torch.equal(layer(x, key_mask), want)


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _affine(d, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (1 + 0.5 * torch.randn(d, generator=gen, device=dev),
            0.5 * torch.randn(d, generator=gen, device=dev))


def _within_one_ulp(got, want):
    """Each bf16 element within one ulp of the larger of the two, or, where
    the affine cancels to near zero, within 2^-16 (the float32 sums' order
    moves such a value by ~1e-6)."""
    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=2.0 ** -100))) - 7)
    return bool(((g - w).abs() <= torch.maximum(ulp, torch.full_like(ulp, 2.0 ** -16))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 32768])
@pytest.mark.parametrize("d", WIDTHS)
def test_kernel_against_plain(dev, d, rows):
    gen = torch.Generator(device=dev).manual_seed(d + rows)
    # a mean far from zero in part of the rows: the centred variance keeps it
    x = (torch.randn(rows, d, generator=gen, device=dev) * 2
         + torch.randn(rows, 1, generator=gen, device=dev) * 8).to(torch.bfloat16)
    delta = torch.randn(rows, d, generator=gen, device=dev).to(torch.bfloat16)
    weight, bias = _affine(d, dev, d)
    before = ln.LAUNCHES["layer_norm"]
    y = ln.layer_norm(x, weight, bias)
    s, ys = ln.add_layer_norm(x, delta, weight, bias)
    torch.cuda.synchronize(dev)
    assert ln.LAUNCHES["layer_norm"] == before + 2
    assert torch.equal(s, x + delta)  # the bf16 add, bit for bit
    assert _within_one_ulp(y, ln.plain_layer_norm(x, weight, bias))
    assert _within_one_ulp(ys, ln.plain_layer_norm(x + delta, weight, bias))
    # a misplaced affine or a wrong statistic is not within one ulp
    assert not _within_one_ulp(y, ln.plain_layer_norm(x, weight, torch.zeros_like(bias)))


@pytest.mark.cuda
def test_other_widths_and_views(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    norm = esm2.LayerNorm(1280, device=dev).requires_grad_(False)
    for p, value in zip((norm.weight, norm.bias), _affine(1280, dev, 1)):
        p.copy_(value)
    x = torch.randn(64, 2 * 1280, generator=gen, device=dev).to(torch.bfloat16)
    strided, unaligned = x[:, 1280:], x.view(-1)[1:1 + 40 * 1280].view(40, 1280)
    before = ln.LAUNCHES["layer_norm"]
    s, y = norm.add_norm(strided, strided)  # aligned rows of a strided view: the kernel
    assert ln.LAUNCHES["layer_norm"] == before + 1
    assert torch.equal(s, strided + strided)
    assert _within_one_ulp(y, ln.plain_layer_norm(strided + strided, norm.weight, norm.bias))
    # rows that are not 16-byte aligned, or a width not a multiple of 8: the plain version
    assert torch.equal(norm(unaligned), ln.plain_layer_norm(unaligned, norm.weight, norm.bias))
    s, y = norm.add_norm(unaligned, unaligned)  # the plain add; its new sum takes the kernel
    assert torch.equal(s, unaligned + unaligned)
    assert _within_one_ulp(y, ln.plain_layer_norm(s, norm.weight, norm.bias))
    for d in (28, 100, 1001):
        odd = esm2.LayerNorm(d, device=dev)
        xd = torch.randn(7, 3, d, generator=gen, device=dev).to(torch.bfloat16)
        with torch.no_grad():
            assert torch.equal(odd(xd), ln.plain_layer_norm(xd, odd.weight, odd.bias))
        with pytest.raises(ValueError, match="multiple of 8"):
            ln.layer_norm(xd, odd.weight.detach(), odd.bias.detach())
    assert ln.LAUNCHES["layer_norm"] == before + 2
    with pytest.raises(RuntimeError, match="layer_norm launch failed"):
        ln.layer_norm(unaligned, norm.weight, norm.bias)


def _esm(dev):
    model = esm2.init_random(esm2.PRESETS["esm2_t33_650M"], seed=0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for module in model.modules():  # seeded presets have unit scales, zero biases
        if isinstance(module, esm2.LayerNorm):
            module.weight.copy_(1 + 0.2 * torch.randn(module.weight.shape, generator=gen,
                                                      device=dev))
            module.bias.copy_(0.2 * torch.randn(module.bias.shape, generator=gen, device=dev))
    return model


@pytest.mark.cuda
def test_esm_forward_against_plain_norms(dev):
    model = _esm(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    tokens = torch.randint(4, 24, (4, 258), generator=gen, device=dev)
    tokens[:, 0], tokens[:, -1] = esm2.ALPHABET.cls_idx, esm2.ALPHABET.eos_idx
    tokens[1, 200:] = esm2.ALPHABET.padding_idx
    tokens[:, 50] = esm2.ALPHABET.mask_idx
    with torch.no_grad():
        before = ln.LAUNCHES["layer_norm"]
        got = torch.log_softmax(model(tokens), -1)
        launched = ln.LAUNCHES["layer_norm"] - before
        with mock.patch.object(ln, "takes_kernel", lambda *a: False):
            want = torch.log_softmax(model(tokens), -1)
    assert launched == 2 * 33 + 2  # two a layer, the final norm, the head's
    assert ln.LAUNCHES["layer_norm"] - before == launched  # the plain forward launched none
    live = tokens != esm2.ALPHABET.padding_idx
    err = (got - want)[live].abs().max().item()
    assert err < ESM_LOGP_ATOL, err


@pytest.mark.cuda
def test_progen2_forward_launches(dev):
    # progen2-xlarge's depth (32 blocks) at a width that builds in a moment:
    # one norm a block and the final one
    config = ar_zoo.ProGen2Config("progen2-xlarge-depth", 32, 512, 8, 32)
    model = ar_zoo.progen2_init(config, seed=0, device=dev)
    tokens = torch.randint(3, 28, (2, 40), device=dev)
    with torch.no_grad():
        before = ln.LAUNCHES["layer_norm"]
        model(tokens)
    assert ln.LAUNCHES["layer_norm"] - before == 32 + 1


@pytest.mark.cuda
def test_launch_span_counts_the_launches(dev):
    x = torch.randn(64, 1280, device=dev).to(torch.bfloat16)
    weight, bias = _affine(1280, dev, 0)
    ln.layer_norm(x, weight, bias)  # built, outside the trace
    profiler.clear_spans()
    before = ln.LAUNCHES["layer_norm"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ln.layer_norm(x, weight, bias)
            ln.add_layer_norm(x, x, weight, bias)
        torch.cuda.synchronize(dev)
    assert profiler.span_totals()[ln.LAUNCH_SPAN][0] == (
        ln.LAUNCHES["layer_norm"] - before) == 6
    assert ln.LAUNCH_SPAN in {e.name for e in prof.events()}
