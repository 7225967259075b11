"""ESM-C, ESM3, xTrimoPGLM and CARP on the card: ESM3's geometric attention
and structure codes against the CPU at a mid size, K1 at the four shapes
of their scoring paths against its plain version, each model's forward
with the kernels against the same forward with the plain attention (ESM3
past 1,024 tokens through K2's float32 mode), and a CARP forward against
the CPU.

Every test needs an NVIDIA GPU (marker ``cuda``) and skips without one.
The file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_esm3_cuda.py
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from proteingym_tpu_torch.models import carp, esm3, esmc, xtrimo
from proteingym_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# float32 without TF32 on both devices: summation order only
F32_ATOL = 1e-4
# bf16 kernel vs the float32 plain version of the same bf16 inputs
BF16_ATOL = 2e-2
# bf16 models, kernel vs plain attention, log-probs through 2 layers
BF16_LOGP_ATOL = 5e-2


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _coords(n, seed):
    rng = np.random.RandomState(seed)
    ca = np.cumsum(rng.randn(n, 3) * 1.1 + np.array([3.5, 0.4, 0.1]), axis=0)
    return np.stack([ca + rng.randn(n, 3) * 0.3 + np.array([-1.2, 0.4, 0.0]), ca,
                     ca + rng.randn(n, 3) * 0.3 + np.array([1.2, -0.4, 0.0])],
                    axis=1).astype(np.float32)


def _randomized(model, seed):
    """Every parameter N(0, 1 / fan-in) (N(1, 0.1^2) for layer-norm scales):
    large enough that the structure codes differ between residues."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            noise = torch.randn(p.shape, generator=gen)
            if p.dim() == 1:
                p.copy_(1 + 0.1 * noise if name.endswith("weight") else 0.1 * noise)
            else:
                p.copy_(noise / np.sqrt(p.shape[-1]))
    return model


MID_SC = esm3.StructureEncoderConfig(name="mid", d_model=256, v_heads=128, n_layers=2,
                                     d_out=64, n_codes=1024, knn=16)


def test_geometric_attention_on_the_card_equals_cpu(dev):
    torch.manual_seed(0)
    geom = _randomized(esm3.GeometricAttention(256, 64), 1)
    coords = torch.from_numpy(np.stack([_coords(120, 2), _coords(120, 3)]))
    coords[0, 7] = float("nan")
    coords[1, :30] = float("inf")
    x = torch.randn(2, 120, 256)
    with torch.no_grad():
        want = geom(x, *esm3.build_affine_from_coordinates(coords))
        got = geom.to(dev)(x.to(dev), *esm3.build_affine_from_coordinates(coords.to(dev)))
    torch.testing.assert_close(got.cpu(), want, atol=F32_ATOL, rtol=1e-4)


def test_structure_codes_on_the_card_equal_cpu(dev):
    cpu = _randomized(esm3.load_structure_encoder_state_dict(
        esm3.structure_encoder_init(MID_SC, seed=0, device="cpu").state_dict(), MID_SC,
        device="cpu"), 4)
    card = esm3.load_structure_encoder_state_dict(cpu.state_dict(), MID_SC, device=dev)
    coords = _coords(150, 5)
    want = esm3.structure_code_distances(cpu, coords)
    got = esm3.structure_code_distances(card, coords).cpu()
    torch.testing.assert_close(got, want, atol=0.0, rtol=1e-4)
    two = want.topk(2, dim=-1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 1e-2
    assert (got.argmin(-1) == want.argmin(-1))[clear].all()
    assert len(torch.unique(want.argmin(-1))) > 10


# (B, H, T, D, dtype, mode): ESM-C-600M, xTrimoPGLM-1B MLM, xTrimoPGLM-3B AR, ESM3
K1_SHAPES = {
    "esmc_600m": (32, 18, 256, 64, torch.bfloat16, "mask"),
    "xtrimopglm_1b": (32, 16, 252, 128, torch.bfloat16, "mask"),
    "xtrimopglm_3b_ar": (32, 20, 251, 128, torch.bfloat16, "causal"),
    "esm3": (32, 24, 252, 64, torch.float32, "none"),
}


@pytest.mark.parametrize("shape", sorted(K1_SHAPES))
def test_k1_at_the_masked_lm_shapes_matches_plain(shape, dev):
    b, h, t, d, dtype, mode = K1_SHAPES[shape]
    gen = torch.Generator(device=dev).manual_seed(t + d)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(dtype).transpose(1, 2)
               for _ in range(3))
    lengths = torch.randint(t // 2, t + 1, (b,), generator=gen, device=dev)
    kw = {}
    if mode != "none":
        kw["key_mask"] = torch.arange(t, device=dev)[None] < lengths[:, None]
    kw["causal"] = mode == "causal"
    got = fa.grouped_mha(q, k, v, **kw)
    want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
    atol = BF16_ATOL if dtype == torch.bfloat16 else F32_ATOL
    # every query row sees key 0, so every row is defined (pad rows too)
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=atol)


def _counted(fn):
    before = dict(fa.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in fa.LAUNCHES.items() if v != before[k]}


def _tokens(n, t, seed, vocab=(4, 24)):
    gen = torch.Generator().manual_seed(seed)
    toks = torch.randint(*vocab, (n, t), generator=gen)
    toks[:, 0] = 0
    return toks


@pytest.mark.parametrize("family", ["esmc", "xtrimopglm_ar", "esm3", "esm3_long"])
def test_forward_goes_through_the_kernels(family, dev):
    if family == "esmc":
        config = dataclasses.replace(esmc.PRESETS["esmc_tiny"], embed_dim=128, num_heads=2)
        model = esmc.init_random(config, seed=0, device=dev)
        toks = _tokens(3, 70, 1).to(dev)
        toks[1, 50:] = esmc.ALPHABET.padding_idx
        fn, want_launches = (lambda: model(toks)), {"grouped_attention": 2, "rope_qk": 2}
    elif family == "xtrimopglm_ar":
        config = dataclasses.replace(xtrimo.PRESETS["xtrimopglm_tiny"], embed_dim=256, num_heads=2)
        model = esmc.init_random(config, seed=0, device=dev)
        toks = _tokens(3, 61, 2).to(dev)
        fn = lambda: xtrimo.apply(model, toks, "ar")  # noqa: E731
        want_launches = {"grouped_attention": 2, "rope_qk": 2}
    else:
        config = dataclasses.replace(esm3.TINY, d_model=128, n_heads=2, v_heads=8)
        model = esm3.init_random(config, seed=0, device=dev)
        t = 1100 if family == "esm3_long" else 90
        toks = _tokens(2, t, 3).to(dev)
        coords = torch.full((2, t, 3, 3), float("inf"), device=dev)
        coords[:, 1:-1] = torch.from_numpy(_coords(t - 2, 4)).to(dev)
        fn = lambda: model(toks, coords=coords)[0]  # noqa: E731
        want_launches = {"flash_attention" if t > 1024 else "grouped_attention": 2}
    with torch.no_grad():
        got, launches = _counted(fn)
        with mock.patch.object(esmc, "mha", fa.plain_mha):
            want = fn()
    assert launches == want_launches
    atol = F32_ATOL if family.startswith("esm3") else BF16_LOGP_ATOL
    torch.testing.assert_close(torch.log_softmax(got, -1), torch.log_softmax(want, -1),
                               atol=atol, rtol=0)


def test_carp_forward_on_the_card_equals_cpu(dev):
    config = dataclasses.replace(carp.CARP_PRESETS["carp_600k"], num_layers=9,
                                 dtype=torch.float32)
    cpu = carp.init_random(config, seed=0, device="cpu")
    card = carp.convert_torch_state_dict(cpu.state_dict(), config, device=dev)
    toks = _tokens(2, 300, 5, vocab=(0, 25))
    with torch.no_grad():
        want = cpu(toks)
        got = card(toks.to(dev)).cpu()
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=1e-4)
