"""The port's CUDA kernels (the four attention wrappers, grouped, heads-mid,
long-context and extent-sparse segmented, on the Hopper loop with its
pre-pass in bf16 and on the 3xTF32 kernel in float32; cluster counts)
against their plain PyTorch versions on the card, and the model forwards
that launch them (ESM, PoET, the MSA Transformer's column attention,
Tranception's ALiBi causal attention, the AR zoo's float32 causal
attention), and the HMM forward, the Potts,
EVE and WaveNet trainers, PROVEAN's alignment recursion, GEMME and SiteRM
on the card against the CPU.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the kernels have no CPU mode. The file imports neither jax nor the
JAX package, so it runs on a GPU host that has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from proteingym_tpu_torch.devices import adam
from proteingym_tpu_torch.models import (
    ar_zoo, esm2, eve, gemme, hmm, msa_transformer, poet, potts, progen3, provean, siterm,
    tranception, wavenet,
)
from proteingym_tpu_torch.msa import weights as msa_weights
from proteingym_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# float32: the kernel's 3xTF32 products (~2^-21 relative each) and the
# summation order differ. bf16: the kernel rounds the scaled and rotated
# q/k, the probabilities and the output to bf16.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _lengths_mask(t, lengths):
    return torch.arange(t)[None, :] < torch.tensor(lengths)[:, None]


def _segments(t):
    seg = torch.zeros(2, t, dtype=torch.int32)
    seg[0, :12], seg[0, 12:30], seg[0, 30:35] = 1, 2, 3
    seg[1, :22] = 1
    return seg


def _alibi(h, t):
    slopes = 2.0 ** (-8.0 * torch.arange(1, h + 1) / h)
    return slopes[:, None] * torch.arange(t)[None, :]


# name -> (T, head dim, keyword arguments)
CASES = {
    "plain": (40, 64, {}),
    "padding": (40, 64, {"key_mask": _lengths_mask(40, [40, 25])}),
    "rope_padding": (37, 64, {"rope_base": 10000.0, "key_mask": _lengths_mask(37, [37, 20])}),
    "segmented_rope": (40, 64, {"segment_ids": _segments(40), "key_mask": _segments(40) > 0,
                                "rope_base": 10000.0}),
    "causal": (130, 64, {"causal": True}),
    "alibi_causal": (384, 64, {"bias": _alibi(4, 384), "causal": True}),
    "all_masked_row": (100, 32, {"key_mask": torch.stack([torch.ones(100, dtype=torch.bool),
                                                          torch.zeros(100, dtype=torch.bool)])}),
    "scale": (70, 32, {"sm_scale": 0.3, "rope_base": 10000.0}),
    "hd16": (77, 16, {"rope_base": 10000.0, "key_mask": _lengths_mask(77, [77, 50])}),
    "hd24": (77, 24, {"rope_base": 10000.0, "key_mask": _lengths_mask(77, [77, 50])}),
    "hd128": (150, 128, {"rope_base": 10000.0, "key_mask": _lengths_mask(150, [150, 99])}),
    "long_T": (1100, 64, {"rope_base": 10000.0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_attention_kernel_matches_plain(case, dtype, dev):
    t, d, kw = CASES[case]
    gen = torch.Generator().manual_seed(sorted(CASES).index(case))
    # (B, T, H, D) memory seen as (B, H, T, D), as the model hands it in
    q, k, v = (torch.randn(2, t, 4, d, generator=gen).to(dev, dtype).permute(0, 2, 1, 3)
               for _ in range(3))
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = fa.LAUNCHES["grouped_attention"]
    got = fa.grouped_mha(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["grouped_attention"] == before + 1
    want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
    if "segment_ids" in kw:  # padding rows are never consumed
        live = (kw["segment_ids"] > 0).cpu()
        got, want = (x.transpose(1, 2).cpu()[live] for x in (got, want))
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_unaligned_bf16_views_match_plain(dev):
    # views starting one element into a buffer, with odd strides: the
    # wrapper copies them before the kernel's 16-byte staging loads
    gen = torch.Generator().manual_seed(5)
    buf = torch.randn(3, 2, 4, 50 * 65 + 1, generator=gen).to(dev, torch.bfloat16)
    q, k, v = (b[..., 1:].view(2, 4, 50, 65)[..., :64] for b in buf)
    mask = _lengths_mask(50, [50, 31]).to(dev)
    got = fa.grouped_mha(q, k, v, key_mask=mask, rope_base=10000.0).float()
    want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask, rope_base=10000.0)
    torch.testing.assert_close(got, want, atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


def test_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 2, 16, 40, device=dev)
    with pytest.raises(ValueError, match="head dim 40"):
        fa.grouped_mha(q, q, q)
    q = torch.zeros(1, 2, 16, 32, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.grouped_mha(q, q, q)
    q = torch.zeros(1, 2, 32, 16, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="unit head-dim stride"):
        fa.grouped_mha(q, q, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_model_forward_goes_through_the_kernel(dtype, dev):
    config = esm2.EsmConfig("esm2_small", 3, 128, 4, dtype=dtype)
    model = esm2.init_random(config, seed=0, device=dev)
    toks = torch.from_numpy(np.stack([esm2.ALPHABET.tokenize("MKTAYIAKQRQISFVKSHF", pad_to=24),
                                      esm2.ALPHABET.tokenize("GLIEVQAPILSRVGDG", pad_to=24)]))
    toks = toks.long().to(dev)
    before = dict(fa.LAUNCHES)
    got = model(toks)
    # ESM's attention runs at the (B, T, H, D) layout: the heads-mid entry
    assert fa.LAUNCHES["grouped_attention_bthd"] == (
        before["grouped_attention_bthd"] + config.num_layers)
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(esm2, "mha_natural", fa.plain_mha_bthd)
        want = model(toks)
    torch.testing.assert_close(got, want, atol=TOL[dtype] * 5, rtol=0)


# the long-context kernel (K2): name -> (T, head dim, keyword arguments). In
# bf16 it runs the Hopper loop after the pre-pass (q scaled, no rotation),
# in float32 the 3xTF32 kernel
FLASH_CASES = {
    "plain": (1100, 64, {}),
    "causal_mask": (2048, 64, {"causal": True, "key_mask": _lengths_mask(2048, [2048, 1500])}),
    "alibi_causal": (1536, 64, {"bias": _alibi(4, 1536), "causal": True}),
    "dead_rows_causal": (1037, 32, {"causal": True, "key_mask": torch.stack([
        torch.arange(1037) >= 7, torch.zeros(1037, dtype=torch.bool)])}),
    # rows 1024..1059 of batch row 1 see no live key: the last query tile's
    # first warpgroup must not skip the tile in its future (keys 1088..1099,
    # whose v the test offsets so that dropping them moves those rows by ~0.09)
    "dead_rows_in_the_last_query_tile": (1100, 64, {"causal": True, "key_mask": torch.stack([
        torch.ones(1100, dtype=torch.bool), torch.arange(1100) >= 1060])}),
    "hd24_scale": (1111, 24, {"sm_scale": 0.3, "key_mask": _lengths_mask(1111, [1111, 999])}),
    "hd128_causal": (1200, 128, {"causal": True}),
    "prescaled_no_prepass": (1300, 64, {"sm_scale": 1.0, "causal": True,
                                        "key_mask": _lengths_mask(1300, [1300, 1250])}),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(case, dtype, dev):
    t, d, kw = FLASH_CASES[case]
    gen = torch.Generator().manual_seed(50 + sorted(FLASH_CASES).index(case))
    q, k, v = (torch.randn(2, t, 4, d, generator=gen).to(dev, dtype).permute(0, 2, 1, 3)
               for _ in range(3))
    if kw.get("sm_scale") == 1.0:  # the caller pre-scaled q
        q = q * d ** -0.5
    if case == "dead_rows_in_the_last_query_tile":  # the dead rows' mean of v
        v = v.clone()
        v[:, :, 1088:] += 8  # each dead row gains 8 * 12 / 1100 from these keys
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = dict(fa.LAUNCHES)
    got = fa.flash_mha(q, k, v, **kw).float()
    torch.cuda.synchronize()
    prepass = dtype == torch.bfloat16 and kw.get("sm_scale") != 1.0
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        **{n: 0 for n in fa.LAUNCHES}, "flash_attention": 1, "rope_qk": int(prepass)}
    want = fa.reference_mha(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def _per_row(fn, plain, q, k, v, **kw):
    """The call on the whole batch and its plain version one batch row at a
    time (a float32 (H, T, T) score block per row), both float32."""
    got = fn(q, k, v, **kw).float()
    torch.cuda.synchronize()
    rows = {n: x for n, x in kw.items() if n in ("key_mask", "segment_ids")}
    rest = {n: x for n, x in kw.items() if n not in rows and n != "key_tiles"}
    want = torch.cat([plain(*(x[i:i + 1].float() for x in (q, k, v)),
                            **{n: x[i:i + 1] for n, x in rows.items()}, **rest)
                      for i in range(q.shape[0])])
    return got, want


def test_flash_kernel_at_poet_multi_tier_shape(dev):
    # PoET's multi tier at batch 8: causal, each row its own valid length, one
    # row whose first 300 keys are masked (its first rows see no live key),
    # the forward's shared KeyTiles; every row is compared
    b, h, t, d = 8, 16, 4352, 64
    gen = torch.Generator().manual_seed(4352)
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16).permute(0, 2, 1, 3)
               for _ in range(3))
    mask = _lengths_mask(t, [t - 37 * i for i in range(b)]).to(dev)
    mask[3, :300] = False
    tiles = fa.KeyTiles(key_mask=mask, causal=True)
    before = dict(fa.LAUNCHES)
    got, want = _per_row(fa.flash_mha, fa.reference_mha, q, k, v, key_mask=mask, causal=True,
                         key_tiles=tiles)
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"] + 1
    torch.testing.assert_close(got, want, atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


def test_dispatcher_takes_the_flash_kernel_beyond_1024(dev):
    q = torch.randn(1, 2, 1025, 16, device=dev, dtype=torch.bfloat16)
    seg = torch.ones(1, 1025, dtype=torch.int32, device=dev)
    before = dict(fa.LAUNCHES)
    fa.mha(q, q, q, causal=True, rope_base=10000.0)
    fa.mha(q, q, q, causal=True, segment_ids=seg)
    fa.mha(q[:, :, :1024], q[:, :, :1024], q[:, :, :1024])
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"] + 2
    # each call scales q in the pre-pass (the default scale)
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"] + 3


def test_flash_kernel_rejects_what_it_does_not_take(dev):
    q = torch.zeros(1, 2, 1100, 40, device=dev)
    with pytest.raises(ValueError, match="head dim 40"):
        fa.flash_mha(q, q, q)
    q = torch.zeros(1, 2, 1100, 32, device=dev)
    with pytest.raises(ValueError, match="key_mask must be"):
        fa.flash_mha(q, q, q, key_mask=torch.ones(1, 1000, dtype=torch.bool, device=dev))


# the heads-mid entry (K4): name -> (B, T, H, D, keyword arguments)
BTHD_CASES = {
    "mask_rope": (4, 256, 20, 64, {"key_mask": _lengths_mask(256, [252, 250, 201, 64]),
                                   "rope_base": 10000.0}),
    "segmented": (2, 40, 4, 64, {"segment_ids": _segments(40), "key_mask": _segments(40) > 0}),
    "causal": (2, 130, 4, 32, {"causal": True}),
    "causal_mask": (2, 100, 4, 32, {"causal": True, "key_mask": _lengths_mask(100, [100, 61])}),
    "all_masked_row": (2, 100, 4, 32, {"key_mask": torch.stack(
        [torch.ones(100, dtype=torch.bool), torch.zeros(100, dtype=torch.bool)])}),
    "hd24_scale": (2, 77, 4, 24, {"sm_scale": 0.3, "rope_base": 10000.0}),
    # MULAN-small's trunk: 20 heads of 24, each row its own pad tail, RoPE
    "hd24_mask_rope": (4, 252, 20, 24, {"key_mask": _lengths_mask(252, [252, 240, 131, 30]),
                                        "rope_base": 10000.0}),
    # ESM2-3B's trunk (VespaG's): 40 heads of 64, one L=250 row, RoPE
    "hd64_h40_esm2_3b": (2, 252, 40, 64, {"key_mask": _lengths_mask(252, [252, 190]),
                                          "rope_base": 10000.0}),
    "hd128_T1024": (1, 1024, 2, 128, {"rope_base": 10000.0,
                                      "key_mask": _lengths_mask(1024, [1000])}),
}


@pytest.mark.parametrize("case", sorted(BTHD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_bthd_entry_matches_plain(case, dtype, dev):
    b, t, h, d, kw = BTHD_CASES[case]
    gen = torch.Generator().manual_seed(30 + sorted(BTHD_CASES).index(case))
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, dtype) for _ in range(3))
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = dict(fa.LAUNCHES)
    got = fa.grouped_mha_bthd(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["grouped_attention_bthd"] == before["grouped_attention_bthd"] + 1
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"]
    assert got.shape == (b, t, h, d)
    want = fa.plain_mha_bthd(q.float(), k.float(), v.float(), **kw)
    if "segment_ids" in kw:  # padding rows are never consumed
        live = (kw["segment_ids"] > 0).cpu()
        got, want = got.cpu()[live], want.cpu()[live]
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def _runs(b, t, bounds):
    seg = torch.zeros(b, t, dtype=torch.int32)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[:, lo:hi] = i + 1
    return seg


def _holes(seg, *spans):
    """seg > 0 with the keys of each (row, start, stop) span masked too."""
    mask = seg > 0
    for row, lo, hi in spans:
        mask[row, lo:hi] = False
    return mask


# the extent-sparse kernel (K3): name -> (T, head dim, segment ids, keyword
# arguments); segments cross the 64-token tiles. In bf16 it runs the Hopper
# loop after the pre-pass, in float32 the 3xTF32 kernel
SEG_CASES = {
    "tail_and_crossings": (512, 64, _runs(2, 512, [0, 200, 310, 470]), {}),
    "one_segment": (512, 64, _runs(2, 512, [0, 512]), {"rope_base": 10000.0}),
    "rope_sixteen": (4096, 64, _runs(1, 4096, list(range(0, 4001, 250))), {"rope_base": 10000.0}),
    "ragged_T": (1100, 32, _runs(2, 1100, [0, 90, 91, 500, 1037]), {"rope_base": 10000.0}),
    "scale_hd16": (300, 16, _runs(2, 300, [0, 120, 260]), {"sm_scale": 0.3}),
    "hd128": (1152, 128, _runs(1, 1152, [0, 300, 700, 1100]), {}),
    "mask_holes_prescaled": (1300, 64, _runs(2, 1300, [0, 250, 500, 750, 1000, 1250]),
                             {"sm_scale": 1.0, "rope_base": 10000.0,
                              "key_mask": _holes(_runs(2, 1300, [0, 250, 500, 750, 1000, 1250]),
                                                 (0, 230, 250), (1, 700, 720))}),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_seg_block_kernel_matches_plain(case, dtype, dev):
    t, d, seg, kw = SEG_CASES[case]
    b = seg.shape[0]
    gen = torch.Generator().manual_seed(70 + sorted(SEG_CASES).index(case))
    q, k, v = (torch.randn(b, t, 4, d, generator=gen).to(dev, dtype).permute(0, 2, 1, 3)
               for _ in range(3))
    if kw.get("sm_scale") == 1.0:  # the caller pre-scaled q, as ESM does
        q = q * d ** -0.5
    seg = seg.to(dev)
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = dict(fa.LAUNCHES)
    got = fa.seg_block_mha(q, k, v, seg, **kw).float()
    torch.cuda.synchronize()
    prepass = dtype == torch.bfloat16 and (kw.get("sm_scale") != 1.0 or "rope_base" in kw)
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == {
        **{n: 0 for n in fa.LAUNCHES}, "seg_block_attention": 1, "rope_qk": int(prepass)}
    want = fa.plain_seg_block_mha(q.float(), k.float(), v.float(), seg, **kw)
    live = (seg > 0).cpu()  # padding queries are never consumed
    if "key_mask" in kw:
        live &= kw["key_mask"].cpu()
    tr = lambda x: x.transpose(1, 2).cpu()[live]
    torch.testing.assert_close(tr(got), tr(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_seg_block_kernel_at_segment_packed_shape(dev):
    # ESM's segment-packed rows at batch 8: 16 segments of ~250 tokens, each
    # row its own cuts, then padding; the unfolded key mask and the forward's
    # shared KeyTiles; live rows are compared
    b, h, t, d = 8, 20, 4096, 64
    gen = torch.Generator().manual_seed(4096)
    seg = torch.zeros(b, t, dtype=torch.int32)
    for i in range(b):
        lengths = 250 + torch.randint(-20, 6, (16,), generator=gen)
        ends = torch.cumsum(lengths, 0).tolist()
        seg[i] = _runs(1, t, [0, *ends])[0]
    seg = seg.to(dev)
    mask = seg > 0
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16).permute(0, 2, 1, 3)
               for _ in range(3))
    q = q * d ** -0.5  # ESM pre-scales q and passes sm_scale=1
    tiles = fa.KeyTiles(seg, mask)
    kw = dict(segment_ids=seg, key_mask=mask, sm_scale=1.0, rope_base=10000.0, key_tiles=tiles)
    before = dict(fa.LAUNCHES)
    got, want = _per_row(lambda q, k, v, segment_ids, **kw: fa.seg_block_mha(
        q, k, v, segment_ids, **kw), lambda q, k, v, segment_ids, **kw: fa.plain_seg_block_mha(
        q, k, v, segment_ids, **kw), q, k, v, **kw)
    assert fa.LAUNCHES["seg_block_attention"] == before["seg_block_attention"] + 1
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"] + 1
    live = mask.cpu()
    tr = lambda x: x.transpose(1, 2).cpu()[live]
    torch.testing.assert_close(tr(got), tr(want), atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dispatcher_folds_the_key_mask_into_the_extent_sparse_kernel(dtype, dev):
    # the JAX dispatch folds the key mask into the ids; the port hands the
    # mask to the kernel as its own operand, and live rows see the same keys
    t = 1152
    gen = torch.Generator().manual_seed(90)
    q, k, v = (torch.randn(2, t, 4, 64, generator=gen).to(dev, dtype).permute(0, 2, 1, 3)
               for _ in range(3))
    seg = _runs(2, t, [0, 300, 700, 1100]).to(dev)
    mask = seg > 0
    mask[1, 650:700] = False  # masked keys at a segment's tail
    before = dict(fa.LAUNCHES)
    got = fa.mha(q, k, v, key_mask=mask, segment_ids=seg, rope_base=10000.0).float()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["seg_block_attention"] == before["seg_block_attention"] + 1
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"]
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"] + int(dtype == torch.bfloat16)
    want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask, segment_ids=seg,
                        rope_base=10000.0)
    live = mask.cpu()
    tr = lambda x: x.transpose(1, 2).cpu()[live]
    torch.testing.assert_close(tr(got), tr(want), atol=TOL[dtype], rtol=TOL[dtype])


def test_k3_and_k4_reject_what_they_do_not_take(dev):
    q = torch.zeros(1, 64, 2, 32, device=dev)
    with pytest.raises(TypeError):
        fa.grouped_mha_bthd(q, q, q, bias=torch.zeros(2, 64, device=dev))
    with pytest.raises(ValueError, match="head dim 40"):
        fa.grouped_mha_bthd(*(torch.zeros(1, 64, 2, 40, device=dev),) * 3)
    with pytest.raises(ValueError, match="key_mask must be"):
        fa.grouped_mha_bthd(q, q, q, key_mask=torch.ones(1, 60, dtype=torch.bool, device=dev))
    qh = q.transpose(1, 2)
    with pytest.raises(ValueError, match="segment_ids must be"):
        fa.seg_block_mha(qh, qh, qh, torch.ones(1, 60, dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.seg_block_mha(*(qh.half(),) * 3, torch.ones(1, 64, dtype=torch.int32, device=dev))
    with pytest.raises(TypeError):
        fa.seg_block_mha(qh, qh, qh, torch.ones(1, 64, device=dev), causal=True)


@pytest.mark.parametrize("t,entry", [(1152, "seg_block_attention"),
                                     (256, "grouped_attention_bthd")])
def test_segmented_model_forward_takes_the_expected_kernel(t, entry, dev):
    # two packed segments per row, then padding: beyond 1024 tokens the
    # extent-sparse kernel runs, up to 1024 the heads-mid entry
    config = esm2.EsmConfig("esm2_small", 3, 128, 4, dtype=torch.bfloat16)
    model = esm2.init_random(config, seed=0, device=dev)
    rng = np.random.default_rng(t)
    toks = torch.full((2, t), esm2.ALPHABET.padding_idx, dtype=torch.long)
    seg = torch.zeros(2, t, dtype=torch.int32)
    for row, lens in enumerate(([t // 3, t // 2], [t // 4, t // 2 + 10])):
        begin = 0
        for s, n in enumerate(lens, start=1):
            residues = "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n - 2))
            toks[row, begin:begin + n] = torch.from_numpy(esm2.ALPHABET.tokenize(residues))
            seg[row, begin:begin + n] = s
            begin += n
    toks, seg = toks.to(dev), seg.to(dev)
    apply_fn = esm2.make_segmented_apply_fn(model)
    before = dict(fa.LAUNCHES)
    got = apply_fn(toks, seg)
    torch.cuda.synchronize()
    counts = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    # both entries run the Hopper loop on q/k rotated by the pre-pass
    assert counts == {**{n: 0 for n in fa.LAUNCHES}, entry: config.num_layers,
                      "rope_qk": config.num_layers}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(esm2, "mha_natural", fa.plain_mha_bthd)
        want = apply_fn(toks, seg)
    live = (seg > 0)
    torch.testing.assert_close(got[live], want[live], atol=0.1, rtol=0)


# the Hopper loop (K1 and K4 in bf16): every mode at every head dim and at
# T = 77 (one ragged query tile), 256, 1024 and 4352 (PoET's self tier).
# name -> keyword arguments built for (B, T) on the card
def _hopper_kwargs(mode, b, h, t, dev):
    gen = torch.Generator().manual_seed(t)
    lengths = [t, max(1, t - 1 - int(torch.randint(0, t // 2 + 1, (1,), generator=gen)))]
    mask = _lengths_mask(t, lengths[:b]).to(dev)
    # each batch row its own cuts: the extents are read per row
    seg = torch.cat([_runs(1, t, sorted({0, t // (5 + 2 * i), t // (5 + 2 * i) + 1,
                                         t // (2 + i), t - max(1, t // (9 - 3 * i))}))
                     for i in range(b)]).to(dev)
    if mode == "mask_rope":
        return {"key_mask": mask, "rope_base": 10000.0}
    if mode == "scale_no_rope":
        return {"sm_scale": 0.3, "key_mask": mask}
    if mode == "prescaled_no_prepass":
        return {"sm_scale": 1.0}
    if mode == "segments_rope":
        return {"segment_ids": seg, "key_mask": seg > 0, "rope_base": 10000.0}
    if mode == "segments_causal_rope":
        return {"segment_ids": seg, "causal": True, "rope_base": 10000.0}
    if mode == "causal_dead_rows":
        dead = mask.clone()
        dead[-1, : min(t, 150)] = False  # these rows see no live key at or before them
        return {"key_mask": dead, "causal": True}
    if mode == "alibi_causal":
        return {"bias": _alibi(h, t).to(dev), "causal": True}
    raise ValueError(mode)


HOPPER_MODES = ["mask_rope", "scale_no_rope", "prescaled_no_prepass", "segments_rope",
                "segments_causal_rope", "causal_dead_rows", "alibi_causal"]


@pytest.mark.parametrize("t", [77, 256, 1024, 4352])
@pytest.mark.parametrize("d", [16, 24, 32, 64, 128])
@pytest.mark.parametrize("mode", HOPPER_MODES)
def test_hopper_loop_matches_plain(mode, d, t, dev):
    b, h = 2, 2
    gen = torch.Generator().manual_seed(d * t)
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16).permute(0, 2, 1, 3)
               for _ in range(3))
    kw = _hopper_kwargs(mode, b, h, t, dev)
    before = dict(fa.LAUNCHES)
    got = fa.grouped_mha(q, k, v, **kw).float()
    torch.cuda.synchronize()
    prepass = kw.get("rope_base") is not None or kw.get("sm_scale", 0.0) != 1.0
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"] + 1
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"] + int(prepass)
    want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
    tr = lambda x: x.transpose(1, 2).cpu()
    got, want = tr(got), tr(want)
    if "segment_ids" in kw:  # live rows; padding rows are never consumed
        live = (kw["segment_ids"] > 0).cpu()
        got, want = got[live], want[live]
    torch.testing.assert_close(got, want, atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [300, 1037])
def test_hopper_loop_honours_ids_that_come_back(t, causal, dev):
    # batch row 0: the last run takes the first run's id; row 1: contiguous
    # runs with falling ids; row 2: rising runs (its extents stay tight)
    b, h, d = 3, 2, 64
    seg = torch.cat([_runs(1, t, [0, t // 4, t // 2, t - 20]) for _ in range(b)])
    seg[0, t // 2:t - 20] = 1
    seg[1, :t // 4] = 3
    seg[1, t // 2:t - 20] = 1
    gen = torch.Generator().manual_seed(t)
    q, k, v = (torch.randn(b, h, t, d, generator=gen).to(dev, torch.bfloat16) for _ in range(3))
    kw = {"segment_ids": seg.to(dev), "causal": causal, "rope_base": 10000.0}
    lo, hi = fa._key_tile_extents(b, t, kw["segment_ids"], None, causal, dev)
    assert int(lo[:2].max()) == 0 and int(lo[2].max()) > 0
    got = fa.grouped_mha(q, k, v, **kw).float()
    want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
    live = (seg > 0)
    tr = lambda x: x.transpose(1, 2).cpu()[live]
    torch.testing.assert_close(tr(got), tr(want), atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("t", [77, 256, 1024])
@pytest.mark.parametrize("d", [16, 24, 32, 64, 128])
def test_hopper_loop_heads_mid_entry_matches_plain(d, t, dev):
    b, h = 3, 4
    gen = torch.Generator().manual_seed(d + t)
    q, k, v = (torch.randn(b, t, h, d, generator=gen).to(dev, torch.bfloat16)
               for _ in range(3))
    kw = {"key_mask": _lengths_mask(t, [t, t - 3, t // 2]).to(dev), "rope_base": 10000.0}
    before = dict(fa.LAUNCHES)
    got = fa.grouped_mha_bthd(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["grouped_attention_bthd"] == before["grouped_attention_bthd"] + 1
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"] + 1
    want = fa.plain_mha_bthd(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got, want, atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [16, 24, 64, 128])
def test_rope_qk_kernel_matches_plain(d, dev):
    gen = torch.Generator().manual_seed(d)
    q, k = (torch.randn(2, 300, 3, d, generator=gen).to(dev, torch.bfloat16).permute(0, 2, 1, 3)
            for _ in range(2))
    for scale, base in ((0.125, 10000.0), (1.0, 10000.0), (0.3, None)):
        before = fa.LAUNCHES["rope_qk"]
        got = fa.rope_qk(q, k, scale, base)
        torch.cuda.synchronize()
        assert fa.LAUNCHES["rope_qk"] == before + 1
        want = fa.plain_rope_qk(q, k, scale, base)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == torch.bfloat16
            assert torch.equal(g, w)  # the plain version's rounding, bit for bit


def test_hopper_loop_refuses_unrotated_bf16_calls(dev):
    q = torch.zeros(1, 2, 64, 32, device=dev, dtype=torch.bfloat16)
    lib = fa._kernel_lib()
    strides = fa._strides(q, q, q, q)
    err = lib.pgym_grouped_attention(q.data_ptr(), q.data_ptr(), q.data_ptr(), q.data_ptr(),
                                     strides, 1, 2, 64, 32, 1, None, None, None, 0, None, None,
                                     0.5, None, None, 0, None,
                                     torch.cuda.current_stream().cuda_stream)
    assert err != 0  # a scale other than 1 needs the pre-pass and its scratch


def _alignment(seed, n, length):
    rng = np.random.default_rng(seed)
    centres = rng.integers(1, 21, (max(1, n // 8), length))
    m = centres[rng.integers(0, len(centres), n)]
    sub = rng.random((n, length)) < rng.uniform(0.0, 0.15, (n, 1))
    m[sub] = rng.integers(0, 22, sub.sum())  # amino acids, gaps, code 21
    if n > 4:
        m[1] = 0  # an all-gap row
        m[3] = m[4]  # duplicated rows
    return m.astype(np.int8)


# theta 0.32: rows that agree at 17 of 25 columns are a float32 threshold
# tie (17 > float32(0.68) * 25 is false), a miss on both sides
TIE_THETA = 0.32


def _ties(n):
    """n rows of L=25 cycling through three rows; rows 0 and 1 agree at 17
    of their 25 columns, so every pair of them is a tie at TIE_THETA."""
    base = (np.arange(25) % 20 + 1).astype(np.int8)
    other = base.copy()
    other[:8] = other[:8] % 20 + 1
    return np.stack([base, other, base[::-1]])[np.arange(n) % 3]


# the kernel's tiles are 128 rows x 256 columns and 128 one-hot bytes (6.4
# alignment columns) deep: N below, at and past a tile side, N that crosses
# both sides (389, 4099), one chunk of depth (L=5), 47 (L=300) and 157
# (L=1000); _alignment adds code 21, an all-gap row and duplicated rows
@pytest.mark.parametrize("n,length", [(1, 5), (63, 7), (65, 300), (1000, 123), (3000, 517),
                                      (1, 1000), (127, 300), (129, 5), (389, 1000),
                                      (4099, 300), (4099, 5)])
@pytest.mark.parametrize("theta", [0.2, TIE_THETA])
def test_cluster_count_kernel_equals_plain(n, length, theta, dev):
    m = torch.from_numpy(_alignment(n + length, n, length))
    before = msa_weights.LAUNCHES["cluster_counts"]
    got = msa_weights.num_cluster_members_cuda(m.to(dev), 1.0 - theta)
    torch.cuda.synchronize()
    assert msa_weights.LAUNCHES["cluster_counts"] == before + 1
    assert torch.equal(got, msa_weights.num_cluster_members(m.to(dev), 1.0 - theta))
    assert torch.equal(got.cpu(), msa_weights.num_cluster_members(m, 1.0 - theta))


@pytest.mark.parametrize("n", [3, 300, 4099])
def test_cluster_count_kernel_at_threshold_ties(n, dev):
    m = torch.from_numpy(_ties(n))
    before = msa_weights.LAUNCHES["cluster_counts"]
    got = msa_weights.num_cluster_members_cuda(m.to(dev), 1.0 - TIE_THETA)
    torch.cuda.synchronize()
    assert msa_weights.LAUNCHES["cluster_counts"] == before + 1
    want = msa_weights.num_cluster_members(m, 1.0 - TIE_THETA)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, msa_weights.num_cluster_members(m.to(dev), 1.0 - TIE_THETA))
    # each row counts only the rows equal to it: every tie is a miss
    cls = np.arange(n) % 3
    assert torch.equal(want, torch.from_numpy(np.bincount(cls)[cls].astype(np.float32)))


def test_sequence_weights_on_the_card_equal_cpu(dev):
    m = _alignment(7, 500, 90)
    for theta in (0.2, 0.01, 0.32):
        np.testing.assert_array_equal(msa_weights.sequence_weights(m, theta, device="cuda"),
                                      msa_weights.sequence_weights(m, theta, device="cpu"))


def test_poet_forward_goes_through_both_kernels(dev):
    # T > 1024: the self tier takes the grouped kernel, the multi tier the
    # long-context one, once per layer each
    config = poet.PoetConfig("poet_small", 2, 64, 4, 128, dtype=torch.bfloat16)
    model = poet.init_random(config, seed=0, device=dev)
    with torch.no_grad():
        for layer in model.decoder.layers:  # a non-zero FFN output
            layer.linear2.weight.normal_(0.0, 0.02)
    rng = np.random.default_rng(0)
    ctx = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), 70)) for _ in range(16)]
    rows = poet.build_rows(ctx, ["MKTAYIAKQRQISFVKSHF", "GLIEVQAPILSRVGDG"])
    tok, seg, pos, val = (torch.from_numpy(a).to(dev) for a in rows[:4])
    assert tok.shape[1] > 1024
    before = dict(fa.LAUNCHES)
    got = poet.token_logprobs(model, tok, seg, pos, val)
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"] + config.num_layers
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + config.num_layers
    # the self tier's pre-pass rotates and scales, the multi tier's scales q
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"] + 2 * config.num_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(poet, "mha", fa.plain_mha)
        want = poet.token_logprobs(model, tok, seg, pos, val)
    live = val[:, 1:].bool()
    torch.testing.assert_close(got[live], want[live], atol=5e-2, rtol=0)


@pytest.mark.parametrize("length,window,n_windows", [(250, 1024, 1), (1500, 1024, 2)])
def test_wt_marginal_table_through_the_kernel_matches_plain(length, window, n_windows, dev):
    """WT marginals (one forward, or all overlapping windows in one
    forward) launch K4 once per layer; the table equals the plain
    attention's."""
    from proteingym_tpu_torch.models import esm_scoring

    config = esm2.EsmConfig("esm2_small", 3, 128, 4, dtype=torch.float32)
    model = esm2.init_random(config, seed=1, device=dev)
    rs = np.random.RandomState(length)
    tokens = esm2.ALPHABET.tokenize("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), length)))
    if len(tokens) > window:
        assert len(esm_scoring.overlapping_window_plan(len(tokens), window)) == n_windows
    before = fa.LAUNCHES["grouped_attention_bthd"]
    got = esm_scoring.wt_marginal_table_overlapping(model, tokens, window=window)
    assert fa.LAUNCHES["grouped_attention_bthd"] == before + config.num_layers
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(esm2, "mha_natural", fa.plain_mha_bthd)
        want = esm_scoring.wt_marginal_table_overlapping(model, tokens, window=window)
    assert got.shape == (len(tokens), len(esm2.ALPHABET)) and got.device.type == "cuda"
    torch.testing.assert_close(got, want, atol=TOL[torch.float32] * 5, rtol=0)


def test_batched_assay_metrics_on_the_card_equal_cpu(dev):
    """The metric kernels on the card against the same code on the CPU
    (float64), padded rows, ties and NaN labels included."""
    from proteingym_tpu_torch.metrics import core

    rs = np.random.RandomState(0)
    b, n = 12, 3000
    y = rs.normal(size=(b, n))
    s = np.round(0.5 * y + rs.normal(size=(b, n)), 1)
    y_bin = (y > 0.8).astype(float)
    y_bin[3] = np.nan  # an all-NaN label row: MCC NaN
    y_bin[4] = 1.0  # one class: AUC NaN
    valid = np.arange(n)[None, :] < rs.randint(10, n, size=(b, 1))
    cpu = core.metrics_to_numpy(core.batched_assay_metrics(y, y_bin, s, valid))
    out = core.batched_assay_metrics(y, y_bin, s, valid, device=dev)
    assert all(v.device.type == "cuda" for v in out.values())
    card = core.metrics_to_numpy(out)
    for m in cpu:
        np.testing.assert_allclose(card[m], cpu[m], atol=1e-12, rtol=0, equal_nan=True)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("r", [77, 384])
def test_grouped_kernel_at_the_column_attention_layout(r, d, dev):
    """K1 as the MSA Transformer's column attention calls it: (B*C, R, H, D)
    memory seen as (B*C, H, R, D), q pre-scaled (sm_scale 1), a key mask
    with padded rows in some columns and every row of one column masked
    (that column averages v over all R rows)."""
    gen = torch.Generator().manual_seed(r + d)
    bc, h = 2 * 37, 4
    q, k, v = (torch.randn(bc, r, h, d, generator=gen).to(dev, torch.bfloat16).transpose(1, 2)
               for _ in range(3))
    q = (q.float() * d ** -0.5).to(torch.bfloat16)  # as the model scales q
    mask = torch.ones(bc, r, dtype=torch.bool)
    mask[5:9, r - 13:] = False
    mask[11] = False
    mask = mask.to(dev)
    before = dict(fa.LAUNCHES)
    got = fa.mha(q, k, v, key_mask=mask, sm_scale=1.0)
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"] + 1
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"]  # no pre-pass: q came scaled
    want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask, sm_scale=1.0)
    torch.testing.assert_close(got.float(), want, atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    torch.testing.assert_close(got[11].float(), v[11].float().mean(dim=1, keepdim=True)
                               .expand(-1, r, -1), atol=TOL[torch.bfloat16], rtol=0)


def test_grouped_kernel_beyond_65535_batch_head_pairs(dev):
    """More (b, h) pairs than a grid's y dimension holds (65,535): the
    column attention reaches them at 6 grids of 1,024 columns x 12 heads
    (``--batch-size 48``). The Hopper loop spreads them along z."""
    b, h, t, d = 5462, 12, 70, 16  # 65,544 pairs
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    mask[-3:, 50:] = False  # rows in the last z slice
    got = fa.grouped_mha(q, k, v, key_mask=mask, sm_scale=1.0)
    want = fa.plain_mha(q.float(), k.float(), v.float(), key_mask=mask, sm_scale=1.0)
    torch.testing.assert_close(got.float(), want, atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


def test_msa_transformer_forward_goes_through_the_kernel(dev):
    """A bf16 forward at msa_tiny's width: one K1 launch per layer (the
    column attention) and nothing else; the logits equal the same forward
    with the plain attention."""
    config = msa_transformer.MsaTransformerConfig(
        name="msa_tiny_bf16", num_layers=2, embed_dim=64, num_heads=4, ffn_dim=128)
    model = msa_transformer.init_random(config, seed=0, device=dev)
    rs = np.random.RandomState(0)
    aa = "ACDEFGHIKLMNPQRSTVWY-"
    rows = ["".join(rs.choice(list(aa), 40)) for _ in range(24)]
    tokens = torch.from_numpy(msa_transformer.tokenize_msa(rows)).long().to(dev)
    tokens = tokens[None].repeat(3, 1, 1)
    tokens[1, 0, 7] = msa_transformer.ALPHABET.mask_idx
    tokens[2, :, 30:] = msa_transformer.ALPHABET.padding_idx
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        got = model(tokens)
    launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    assert launched == {**{n: 0 for n in fa.LAUNCHES}, "grouped_attention": config.num_layers}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(msa_transformer, "mha", fa.plain_mha)
        want = model(tokens)
    assert got.dtype == torch.float32 and bool(got.isfinite().all())
    torch.testing.assert_close(got, want, atol=5e-2, rtol=0)


def _f32_kwargs(mode, t):
    """The float32 kernel's modes on a (2, t) batch: causal or not, a key
    mask alone (ESM-IF1's encoder), a key mask with an (H, T) bias, segments with their mask, and a batch row
    whose first 40 keys are masked (its first rows see no live key at or
    before them, so they average v over all T keys)."""
    mask = _lengths_mask(t, [t, t - 7])
    dead = torch.ones(2, t, dtype=torch.bool)
    dead[1, :40] = False
    seg = torch.zeros(2, t, dtype=torch.int32)
    seg[0, :t // 3], seg[0, t // 3:t - 5], seg[1, :t - 9] = 1, 2, 1
    return {"causal": {"causal": True}, "full": {}, "mask": {"key_mask": mask},
            "mask_bias_causal": {"key_mask": mask, "bias": _alibi(3, t), "causal": True},
            "segments": {"segment_ids": seg, "key_mask": seg > 0},
            "segments_causal_rope": {"segment_ids": seg, "key_mask": seg > 0, "causal": True,
                                     "rope_base": 10000.0},
            "no_live_key_causal": {"key_mask": dead, "causal": True}}[mode]


F32_MODES = ("causal", "full", "mask", "mask_bias_causal", "segments", "segments_causal_rope",
             "no_live_key_causal")


@pytest.mark.parametrize("mode", F32_MODES)
@pytest.mark.parametrize("t", [45, 300])  # T not a multiple of the key tile (16-64)
@pytest.mark.parametrize("d", fa.F32_HEAD_DIMS)
def test_float32_kernel_matches_plain(d, t, mode, dev):
    """The float32 kernel (3xTF32 on the tensor cores) at every head dim
    it takes, in every mode; one launch each."""
    gen = torch.Generator().manual_seed(d * 1000 + t)
    q, k, v = (torch.randn(2, t, 3, d, generator=gen).to(dev).transpose(1, 2)
               for _ in range(3))
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in _f32_kwargs(mode, t).items()}
    before = fa.LAUNCHES["grouped_attention"]
    got = fa.grouped_mha(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["grouped_attention"] == before + 1
    want = fa.plain_mha(q, k, v, **kw)
    if "segment_ids" in kw:  # padding rows are never consumed
        live = (kw["segment_ids"] > 0).cpu()
        got, want = (x.transpose(1, 2).cpu()[live] for x in (got, want))
    torch.testing.assert_close(got, want, atol=TOL[torch.float32], rtol=TOL[torch.float32])


# The float32 kernel's 3xTF32 products against float64: its largest error
# stays within this factor of the plain float32 version's own (the CPU
# emulation in test_torch_tf32_split.py puts the split at 0.3-1.2x it, one
# TF32 pass at 300-2300x)
F32_SPLIT_FACTOR = 4.0


def _attention64(q, k, v, causal):
    q, k, v = (x.double() for x in (q, k, v))
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    if causal:
        t = s.shape[-1]
        s = s.masked_fill(torch.ones(t, t, dtype=torch.bool, device=s.device).triu(1),
                          float("-inf"))
    return torch.softmax(s, dim=-1) @ v


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", fa.F32_HEAD_DIMS)
def test_float32_kernel_keeps_float32_accuracy(d, causal, dev):
    """A float64 referee: a split that went missing (one TF32 pass on either
    product) puts the kernel ~100x beyond the plain float32 version."""
    gen = torch.Generator().manual_seed(d + causal)
    q, k, v = (torch.randn(2, 256, 4, d, generator=gen).to(dev).transpose(1, 2)
               for _ in range(3))
    want = _attention64(q, k, v, causal)
    got = fa.grouped_mha(q, k, v, causal=causal)
    plain = fa.plain_mha(q, k, v, causal=causal)
    err_kernel = float((got.double() - want).abs().max())
    err_plain = float((plain.double() - want).abs().max())
    assert err_kernel <= F32_SPLIT_FACTOR * err_plain, (err_kernel, err_plain)


def test_float32_kernel_rejects_other_head_dims(dev):
    q = torch.zeros(1, 2, 16, 48, device=dev)
    with pytest.raises(ValueError, match="head dim 48"):
        fa.grouped_mha(q, q, q, causal=True)
    q = torch.zeros(1, 2, 16, 96, device=dev, dtype=torch.bfloat16)  # the bf16 loop: no 96
    with pytest.raises(ValueError, match="head dim 96"):
        fa.grouped_mha(q, q, q, causal=True)


def test_float32_kernel_beyond_65535_batch_head_pairs(dev):
    """More (b, h) pairs than a grid's y dimension holds: the float32
    kernel spreads them along z."""
    b, h, t, d = 5462, 12, 70, 16  # 65,544 pairs
    gen = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).transpose(1, 2)
               for _ in range(3))
    mask = torch.ones(b, t, dtype=torch.bool, device=dev)
    mask[-3:, 50:] = False  # rows in the last z slice
    got = fa.grouped_mha(q, k, v, key_mask=mask, causal=True)
    want = fa.plain_mha(q, k, v, key_mask=mask, causal=True)
    torch.testing.assert_close(got, want, atol=TOL[torch.float32], rtol=TOL[torch.float32])


def test_float32_kernel_on_unaligned_views(dev):
    # views one element into a buffer: the wrapper copies them before the
    # kernel's float4 loads
    gen = torch.Generator().manual_seed(6)
    buf = torch.randn(3, 2 * 4 * 50 * 97 + 1, generator=gen).to(dev)
    q, k, v = (x[1:].view(2, 4, 50, 97)[..., :96] for x in buf)
    got = fa.grouped_mha(q, k, v, causal=True)
    want = fa.plain_mha(q, k, v, causal=True)
    torch.testing.assert_close(got, want, atol=TOL[torch.float32], rtol=TOL[torch.float32])


# the AR zoo at small widths but head dims the card takes (32, 96, 64, 160)
ZOO_FORWARDS = {
    "progen2": (ar_zoo, lambda dt: ar_zoo.progen2_init(
        ar_zoo.ProGen2Config("p2", 2, 256, 8, rotary_dim=16, dtype=dt), device="cuda")),
    "rita": (ar_zoo, lambda dt: ar_zoo.rita_init(
        ar_zoo.RitaConfig("rita", 2, 192, 2, 256, dtype=dt), device="cuda")),
    "protgpt2": (ar_zoo, lambda dt: ar_zoo.gpt2_init(
        ar_zoo.Gpt2Config("g", 2, 128, 2, vocab_size=64, n_ctx=64, dtype=dt), device="cuda")),
    "progen3": (progen3, lambda dt: progen3.init_random(
        progen3.ProGen3Config("p3", 2, 320, 2, num_kv_heads=1, ffn_dim=96, num_experts=4,
                              dtype=dt), device="cuda")),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("family", sorted(ZOO_FORWARDS))
def test_ar_zoo_forward_goes_through_the_float32_kernel(family, dtype, dev):
    """One float32 K1 launch per layer and nothing else; the logits equal
    the same forward with the plain attention (float32 models: summation
    order; bf16 models: a flipped bf16 rounding of an attention output,
    2^-8 relative, moves a logit by far less than 5e-2 over two layers)."""
    module, make = ZOO_FORWARDS[family]
    model = make(dtype)
    toks = torch.randint(0, 25, (3, 37), generator=torch.Generator().manual_seed(2)).to(dev)
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        got = model(toks)
    launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    assert launched == {**{n: 0 for n in fa.LAUNCHES}, "grouped_attention": 2}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(module, "mha", fa.plain_mha)
        want = model(toks)
    assert got.dtype == torch.float32 and bool(got.isfinite().all())
    atol = TOL[torch.float32] if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("t", [256, 416, 1024])
def test_grouped_kernel_with_tranception_alibi_and_pad_tails(t, dev):
    """K1 in Tranception's mode: q pre-scaled by 2^-3 (sm_scale 1), the
    grouped ALiBi bias of 20 heads (up to 0.5 x (T - 1)), causal, and a
    key mask whose pad tail differs per row; held on live query rows.
    T=416 is the bucket of whole indel rows of a ~400-residue target."""
    b, h, d = 8, 20, 64
    gen = torch.Generator(device=dev).manual_seed(t)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    q = q * 0.125
    lengths = [t, t - 1, t - 4, t - 31, t - 64, t - 65, t // 2 + 3, 2]
    mask = _lengths_mask(t, lengths).to(dev)
    bias = tranception.alibi_bias(h, t, dev)
    kw = dict(key_mask=mask, bias=bias, causal=True, sm_scale=1.0)
    before = dict(fa.LAUNCHES)
    got = fa.grouped_mha(q, k, v, **kw)
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"] + 1
    assert fa.LAUNCHES["rope_qk"] == before["rope_qk"]  # no pre-pass: q comes scaled
    want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
    live = mask  # pad queries are never read
    torch.testing.assert_close(got.transpose(1, 2)[live].float(), want.transpose(1, 2)[live],
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


def test_tranception_forward_goes_through_the_kernel(dev):
    """A bf16 forward at the tiny preset's width with head dim 64 (the
    presets'): one K1 launch per layer and nothing else; the log-probs of
    live positions equal the same forward with the plain attention."""
    config = tranception.TranceptionConfig("tiny_bf16", 2, 256, 4, n_ctx=1024)
    model = tranception.init_random(config, seed=0, device=dev)
    rs = np.random.RandomState(0)
    rows = [tranception.VOCAB.tokenize("".join(rs.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)),
                                       pad_to=288) for n in (286, 250, 131, 40)]
    tokens = torch.from_numpy(np.stack(rows)).long().to(dev)
    before = dict(fa.LAUNCHES)
    with torch.no_grad():
        got = torch.log_softmax(model(tokens), -1)
    launched = {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES}
    assert launched == {**{n: 0 for n in fa.LAUNCHES}, "grouped_attention": config.num_layers}
    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(tranception, "mha", fa.plain_mha)
        want = torch.log_softmax(model(tokens), -1)
    live = tokens != tranception.VOCAB.PAD
    assert got.dtype == torch.float32 and bool(got.isfinite().all())
    torch.testing.assert_close(got[live], want[live], atol=5e-2, rtol=0)


def test_grouped_kernel_at_the_indel_bucket_with_every_tail(dev):
    """K1 at B32 H20 T416 (whole indel rows of a ~400-residue target in
    one bucket of 32 tokens): each row its own pad tail of 1-31 tokens, as
    rows of 385-415 tokens have, against the plain version on live rows."""
    b, h, t, d = 32, 20, 416, 64
    gen = torch.Generator(device=dev).manual_seed(416)
    q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev).to(torch.bfloat16)
               .transpose(1, 2) for _ in range(3))
    q = q * 0.125
    mask = _lengths_mask(t, [t - 1 - (i % 31) for i in range(b)]).to(dev)
    kw = dict(key_mask=mask, bias=tranception.alibi_bias(h, t, dev), causal=True, sm_scale=1.0)
    got = fa.grouped_mha(q, k, v, key_tiles=fa.KeyTiles(None, mask, True), **kw)
    want = fa.plain_mha(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got.transpose(1, 2)[mask].float(), want.transpose(1, 2)[mask],
                               atol=TOL[torch.bfloat16], rtol=TOL[torch.bfloat16])


def test_hmm_forward_on_the_card_equals_cpu(dev):
    rs = np.random.RandomState(0)
    matrix = rs.randint(0, 21, (500, 120)).astype(np.int8)
    model = hmm.build_profile_hmm(matrix, rs.rand(500))
    aa = "ACDEFGHIKLMNPQRSTVWYX"
    seqs = ["".join(aa[i] for i in rs.randint(0, 21, n)) for n in rs.randint(1, 160, 300)]
    got = hmm.score_sequences(model, seqs, device=dev)
    want = hmm.score_sequences(model, seqs, device="cpu")
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_potts_training_on_the_card_equals_cpu(dev):
    rs = np.random.RandomState(1)
    matrix = rs.randint(0, 21, (64, 12)).astype(np.int8)
    alphabet = "-ACDEFGHIKLMNPQRSTVWY"
    args = (matrix, rs.rand(64) + 0.1, alphabet, np.arange(1, 13),
            "".join(alphabet[c] for c in matrix[0]))
    got = potts.train_potts_plm(*args, steps=30, device=dev)
    want = potts.train_potts_plm(*args, steps=30, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    np.testing.assert_allclose(got.h, want.h, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.J, want.J, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.losses, want.losses, atol=1e-5, rtol=0)
    muts = ["A1C", "C2W:D3E", "WT"]
    np.testing.assert_allclose(got.delta_hamiltonians(muts, device=dev),
                               got.delta_hamiltonians(muts, device="cpu"), atol=1e-10, rtol=0)


def _params_close(card_model, cpu_model, atol, max_abs):
    """Adam steps: entries agree within ``atol`` except the few whose
    gradient is within float32 noise of 0, which may step the other way."""
    for name, value in card_model.state_dict().items():
        diff = (value.cpu() - cpu_model.state_dict()[name]).abs()
        assert float((diff > atol).float().mean()) <= 1e-3, name
        assert float(diff.max()) <= max_abs, name


def test_eve_training_steps_on_the_card_equal_cpu(dev):
    # every draw made once on the CPU and handed to both sides
    config = eve.EveConfig(seq_len=30, encoder_hidden=(64, 32), decoder_hidden=(32, 64), z_dim=8)
    rs = np.random.RandomState(2)
    rows = torch.zeros(200, 30, 20)
    rows[torch.arange(200)[:, None], torch.arange(30)[None], torch.from_numpy(
        rs.randint(0, 20, (200, 30)))] = 1.0
    probs = torch.from_numpy(rs.rand(200) + 0.1).float()
    gen = torch.Generator().manual_seed(2)
    on_cpu = eve.init_random(config, seed=2, device="cpu")
    on_card = eve.load_state_dict(on_cpu.state_dict(), config, device=dev)
    draws = [(torch.multinomial(probs, eve.BATCH_SIZE, replacement=True, generator=gen),
              torch.randn(eve.BATCH_SIZE, 8, generator=gen), on_cpu.draw_noise(1, gen))
             for _ in range(3)]
    losses = {}
    for side, model, where in (("card", on_card, dev), ("cpu", on_cpu, torch.device("cpu"))):
        optimizer = adam(model.requires_grad_(True), 1e-4)
        losses[side] = [float(eve.train_step(model, optimizer, rows[idx].to(where), 150.0,
                                             z_noise=z.to(where),
                                             decoder_noise=[n.to(where) for n in noise]))
                        for idx, z, noise in draws]
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-5)
    _params_close(on_card, on_cpu, 1e-6, 6e-4)
    trained = eve.train(rows.numpy(), probs.numpy(), config, steps=5, device=dev)
    assert trained.losses.shape == (5,) and np.isfinite(trained.losses).all()


def test_wavenet_steps_and_scores_on_the_card_equal_cpu(dev):
    config = wavenet.WavenetConfig(num_layers=6, max_dilation=8)
    rs = np.random.RandomState(3)
    aa = "ACDEFGHIKLMNPQRSTVWY"
    seqs = ["".join(aa[i] for i in rs.randint(0, 20, n)) for n in rs.randint(20, 60, 100)]
    tokens, mask, probs = (torch.from_numpy(a) for a in wavenet.training_rows(seqs))
    gen = torch.Generator().manual_seed(3)
    picks = [torch.multinomial(probs.float(), config.batch, replacement=True, generator=gen)
             for _ in range(3)]
    on_cpu = wavenet.init_random(config, seed=3, device="cpu")
    on_card = wavenet.load_state_dict(on_cpu.state_dict(), config, device=dev)
    np.testing.assert_allclose(wavenet.score_sequences(on_card, seqs),
                               wavenet.score_sequences(on_cpu, seqs), atol=1e-3, rtol=0)
    losses = {}
    for side, model, where in (("card", on_card, dev), ("cpu", on_cpu, torch.device("cpu"))):
        optimizer = adam(model.requires_grad_(True), config.learning_rate)
        losses[side] = [float(wavenet.train_step(model, optimizer, tokens[idx].to(where),
                                                 mask[idx].to(where))) for idx in picks]
    np.testing.assert_allclose(losses["card"], losses["cpu"], rtol=1e-5)
    _params_close(on_card, on_cpu, 1e-5, 6e-3)


def _baseline_alignment(rs, n, length):
    focus = rs.randint(1, 21, length)
    rows = np.tile(focus, (n, 1))
    sub = rs.rand(n, length) < rs.uniform(0.05, 0.7, n)[:, None]
    rows[sub] = rs.randint(1, 21, sub.sum())
    rows[rs.rand(n, length) < 0.1] = 0
    rows[0] = focus
    return rows.astype(np.int8)


def test_provean_dp_on_the_card_equals_cpu(dev):
    rs = np.random.RandomState(0)
    aa = "ACDEFGHIKLMNPQRSTVWY"
    wt = "".join(aa[i] for i in rs.randint(0, 20, 50))
    homologs = ["".join(aa[rs.randint(20)] if rs.rand() < 0.3 else c for c in wt)
                for _ in range(60)]
    subjects = homologs + ["".join(aa[i] for i in rs.randint(0, 20, n)) for n in (1, 33, 90)]
    np.testing.assert_array_equal(  # every cell a small integer: equal exactly
        provean.align_scores([wt] * len(subjects), subjects, device=dev),
        provean.align_scores([wt] * len(subjects), subjects, device="cpu"))
    clusters = provean.cluster_supporting_set(wt, homologs, max_candidates=40)
    variants = [wt[:i] + wt[i + 2:] for i in range(0, 48, 5)] + [
        wt[:i] + "W" + wt[i + 1:] for i in range(50)]
    np.testing.assert_array_equal(provean.provean_scores(wt, variants, clusters, device=dev),
                                  provean.provean_scores(wt, variants, clusters, device="cpu"))


@pytest.mark.parametrize("use_tree", [None, False])
def test_gemme_on_the_card_equals_cpu(use_tree, dev):
    rs = np.random.RandomState(1)
    matrix = _baseline_alignment(rs, 700, 50)
    weights = rs.rand(700)
    got = gemme.fit_gemme(matrix, weights, use_tree=use_tree, device=dev)
    want = gemme.fit_gemme(matrix, weights, use_tree=use_tree, device="cpu")
    assert got.method == want.method and got.alpha == want.alpha
    for name in ("pred_epi", "pred_ind", "conservation"):  # float64, sums in another order
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-9, rtol=0)


def test_siterm_on_the_card_equals_cpu(dev):
    from scipy.stats import spearmanr

    rs = np.random.RandomState(2)
    matrix = _baseline_alignment(rs, 500, 40)
    weights = rs.rand(500)
    f81 = [siterm.fit_siterm(matrix, weights, max_sequences=256, device=d) for d in (dev, "cpu")]
    np.testing.assert_allclose(f81[0].pi, f81[1].pi, atol=1e-12, rtol=0)
    np.testing.assert_allclose(f81[0].mu, f81[1].mu, rtol=1e-5, atol=0)
    gtr = [siterm.fit_site_rate_matrices(matrix, weights, max_sequences=256, device=d)
           for d in (dev, "cpu")]
    np.testing.assert_array_equal(gtr[0].site_rates, gtr[1].site_rates)
    q = [g.rate_matrices for g in gtr]
    # 100 float32 Adam epochs carry cuSOLVER's and LAPACK's eigenvector
    # rounding forward, as they carry float64 against float32 in the JAX
    # package's own fit (tests/test_torch_siterm.py)
    assert np.linalg.norm(q[0] - q[1]) / np.linalg.norm(q[1]) < 2e-2
    focus = "".join("ACDEFGHIKLMNPQRSTVWY"[c - 1] for c in matrix[0])
    mutants = [f"{focus[p]}{p + 1}{a}" for p in range(40) for a in "ACDW-" if a != focus[p]]
    scores = [siterm.score_mutants_gtr(g, focus, mutants, device=d)
              for g, d in zip(gtr, (dev, "cpu"))]
    np.testing.assert_allclose(scores[0], scores[1], atol=0.1, rtol=0)
    assert spearmanr(scores[0], scores[1])[0] >= 0.999
