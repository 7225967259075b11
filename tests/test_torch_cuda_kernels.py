"""The port's CUDA kernels (grouped attention and its heads-mid entry on
the Hopper loop with its pre-pass, long-context and extent-sparse segmented
attention, cluster counts) against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one; the kernels have no CPU mode. The file imports neither jax nor the
JAX package, so it runs on a GPU host that has neither:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from proteingym_tpu_torch.models import esm2, poet
from proteingym_tpu_torch.msa import weights as msa_weights
from proteingym_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

# float32: only the summation order differs. bf16: the kernel rounds the
# scaled and rotated q/k, the probabilities and the output to bf16.
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


# the long-context kernel: name -> (T, head dim, keyword arguments)
FLASH_CASES = {
    "plain": (1100, 64, {}),
    "causal_mask": (2048, 64, {"causal": True, "key_mask": _lengths_mask(2048, [2048, 1500])}),
    "alibi_causal": (1536, 64, {"bias": _alibi(4, 1536), "causal": True}),
    "dead_rows_causal": (1037, 32, {"causal": True, "key_mask": torch.stack([
        torch.arange(1037) >= 7, torch.zeros(1037, dtype=torch.bool)])}),
    "hd24_scale": (1111, 24, {"sm_scale": 0.3, "key_mask": _lengths_mask(1111, [1111, 999])}),
    "hd128_causal": (1200, 128, {"causal": True}),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_kernel_matches_plain(case, dtype, dev):
    t, d, kw = FLASH_CASES[case]
    gen = torch.Generator().manual_seed(50 + sorted(FLASH_CASES).index(case))
    q, k, v = (torch.randn(2, t, 4, d, generator=gen).to(dev, dtype).permute(0, 2, 1, 3)
               for _ in range(3))
    kw = {n: x.to(dev) if torch.is_tensor(x) else x for n, x in kw.items()}
    before = fa.LAUNCHES["flash_attention"]
    got = fa.flash_mha(q, k, v, **kw).float()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == before + 1
    want = fa.reference_mha(q.float(), k.float(), v.float(), **kw)
    torch.testing.assert_close(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_dispatcher_takes_the_flash_kernel_beyond_1024(dev):
    q = torch.randn(1, 2, 1025, 16, device=dev, dtype=torch.bfloat16)
    seg = torch.ones(1, 1025, dtype=torch.int32, device=dev)
    before = dict(fa.LAUNCHES)
    fa.mha(q, q, q, causal=True, rope_base=10000.0)
    fa.mha(q, q, q, causal=True, segment_ids=seg)
    fa.mha(q[:, :, :1024], q[:, :, :1024], q[:, :, :1024])
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert fa.LAUNCHES["grouped_attention"] == before["grouped_attention"] + 2


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


# the extent-sparse kernel (K3): name -> (T, head dim, segment ids, keyword
# arguments); segments cross the 64-token tiles
SEG_CASES = {
    "tail_and_crossings": (512, 64, _runs(2, 512, [0, 200, 310, 470]), {}),
    "one_segment": (512, 64, _runs(2, 512, [0, 512]), {"rope_base": 10000.0}),
    "rope_sixteen": (4096, 64, _runs(1, 4096, list(range(0, 4001, 250))), {"rope_base": 10000.0}),
    "ragged_T": (1100, 32, _runs(2, 1100, [0, 90, 91, 500, 1037]), {"rope_base": 10000.0}),
    "scale_hd16": (300, 16, _runs(2, 300, [0, 120, 260]), {"sm_scale": 0.3}),
    "hd128": (1152, 128, _runs(1, 1152, [0, 300, 700, 1100]), {}),
}


@pytest.mark.parametrize("case", sorted(SEG_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_seg_block_kernel_matches_plain(case, dtype, dev):
    t, d, seg, kw = SEG_CASES[case]
    b = seg.shape[0]
    gen = torch.Generator().manual_seed(70 + sorted(SEG_CASES).index(case))
    q, k, v = (torch.randn(b, t, 4, d, generator=gen).to(dev, dtype).permute(0, 2, 1, 3)
               for _ in range(3))
    seg = seg.to(dev)
    before = fa.LAUNCHES["seg_block_attention"]
    got = fa.seg_block_mha(q, k, v, seg, **kw).float()
    torch.cuda.synchronize()
    assert fa.LAUNCHES["seg_block_attention"] == before + 1
    want = fa.plain_seg_block_mha(q.float(), k.float(), v.float(), seg, **kw)
    live = (seg > 0).cpu()  # padding queries are never consumed
    tr = lambda x: x.transpose(1, 2).cpu()[live]
    torch.testing.assert_close(tr(got), tr(want), atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dispatcher_folds_the_key_mask_into_the_extent_sparse_kernel(dtype, dev):
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
    # the Hopper loop takes q/k rotated by the pre-pass; K3 rotates on load
    rotated = {"rope_qk": config.num_layers} if entry == "grouped_attention_bthd" else {}
    assert counts == {**{n: 0 for n in fa.LAUNCHES}, entry: config.num_layers, **rotated}
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


@pytest.mark.parametrize("n,length", [(1, 5), (63, 7), (65, 300), (1000, 123), (3000, 517)])
def test_cluster_count_kernel_equals_plain(n, length, dev):
    m = torch.from_numpy(_alignment(n + length, n, length))
    before = msa_weights.LAUNCHES["cluster_counts"]
    got = msa_weights.num_cluster_members_cuda(m.to(dev), 0.8)
    assert msa_weights.LAUNCHES["cluster_counts"] == before + 1
    assert torch.equal(got, msa_weights.num_cluster_members(m.to(dev), 0.8))
    assert torch.equal(got.cpu(), msa_weights.num_cluster_members(m, 0.8))


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
