"""The port's extent-sparse segmented attention (``seg_block_mha``, the K3
route of ``mha``) and heads-mid attention (``grouped_mha_bthd``,
``mha_natural``) against the JAX package's functions, run in Pallas
interpret mode on the CPU.

Both sides get the same float32 inputs, made with numpy from a seed. On
CPU tensors the port's wrappers take their plain PyTorch versions, so
these tests hold the plain versions (the kernels' references on the card)
to the TPU kernels' semantics. The CUDA kernels themselves are compared
with the plain versions in tests/test_torch_cuda_kernels.py (GPU only)
and by chip_smoke.py. Padding queries (segment 0) are never consumed and
compute different garbage on the two sides, so segmented cases compare
live query rows only.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.ops import flash_attention as jfa
from proteingym_tpu_torch.ops import flash_attention as tfa

ATOL = 1e-5  # float32 on both sides; only summation order differs
ROPE_ATOL = 1e-4  # as the JAX test of the rotated kernel: RoPE rounding order differs


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for _ in range(3))


def _live_rows(x, seg):
    """(B, H, T, D) -> the (n_live, H, D) rows of live queries."""
    return np.asarray(x).transpose(0, 2, 1, 3)[seg > 0]


def _runs(t, bounds):
    """One row of segment ids: segment i + 1 on [bounds[i], bounds[i+1])."""
    seg = np.zeros(t, np.int32)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        seg[lo:hi] = i + 1
    return seg


# ---- extents -------------------------------------------------------------

def test_segment_block_extents_match_jax_on_the_documented_case():
    seg = np.zeros((1, 512), np.int32)
    seg[0, :200], seg[0, 200:310], seg[0, 310:470] = 1, 2, 3
    lo, hi = tfa._segment_block_extents(torch.from_numpy(seg), 4, 128)
    np.testing.assert_array_equal(lo.numpy()[0], [0, 0, 1, 2])
    np.testing.assert_array_equal(hi.numpy()[0], [2, 3, 4, 4])
    jlo, jhi = jfa._segment_block_extents(jnp.asarray(seg), 4)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("seed", range(4))
def test_segment_block_extents_match_jax_on_random_segmentations(seed):
    rng = np.random.default_rng(seed)
    b, n_qb = 3, 8
    t = n_qb * 128  # the JAX kernel's block edge
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        cuts = np.sort(rng.choice(np.arange(1, t), rng.integers(1, 12), replace=False))
        live_end = rng.integers(cuts[-1], t + 1)  # a padded tail, maybe empty
        seg[i] = _runs(t, [0, *cuts, live_end])
    lo, hi = tfa._segment_block_extents(torch.from_numpy(seg), n_qb, 128)
    jlo, jhi = jfa._segment_block_extents(jnp.asarray(seg), n_qb)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert lo.dtype == hi.dtype == torch.int32


def test_segment_block_extents_at_the_kernel_tile_cover_every_segment():
    # at the Hopper kernel's tile edge, each query tile's extent holds every
    # key of every segment its queries belong to
    rng = np.random.default_rng(9)
    t, tile = 1024, tfa.KERNEL_TILE
    seg = _runs(t, [0, *np.sort(rng.choice(np.arange(1, t), 9, replace=False)), 1000])[None]
    lo, hi = (x.numpy()[0] for x in tfa._segment_block_extents(torch.from_numpy(seg), t // tile, tile))
    for qt in range(t // tile):
        for s in np.unique(seg[0, qt * tile:(qt + 1) * tile]):
            keys = np.flatnonzero(seg[0] == s)
            assert lo[qt] * tile <= keys.min() and keys.max() < hi[qt] * tile


# ---- seg_block_mha and its dispatch --------------------------------------

def test_seg_block_mha_matches_jax_kernel():
    # segments crossing block edges, a padded tail, one segment spanning
    # every block
    b, h, t, d = 2, 4, 512, 32
    q, k, v = _qkv(7, (b, h, t, d))
    seg = np.stack([_runs(t, [0, 200, 310, 470]), _runs(t, [0, t])])
    want = jfa.seg_block_mha(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(seg),
                             interpret=True)
    got = tfa.seg_block_mha(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg))
    assert got.shape == (b, h, t, d)
    np.testing.assert_allclose(_live_rows(got, seg), _live_rows(want, seg), atol=ATOL, rtol=0)


def test_seg_block_mha_rope_matches_jax_kernel():
    b, h, t, d = 1, 2, 256, 32
    q, k, v = _qkv(8, (b, h, t, d))
    seg = _runs(t, [0, 100, 230])[None]
    want = jfa.seg_block_mha(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(seg),
                             rope_base=10000.0, interpret=True)
    got = tfa.seg_block_mha(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg),
                            rope_base=10000.0)
    np.testing.assert_allclose(_live_rows(got, seg), _live_rows(want, seg),
                               atol=ROPE_ATOL, rtol=0)


def test_seg_block_mha_explicit_scale_matches_jax_kernel():
    b, h, t, d = 1, 2, 256, 16
    q, k, v = _qkv(13, (b, h, t, d))
    seg = _runs(t, [0, 60, 61, 190])[None]  # a one-token segment too
    want = jfa.seg_block_mha(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(seg),
                             sm_scale=0.3, interpret=True)
    got = tfa.seg_block_mha(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg),
                            sm_scale=0.3)
    np.testing.assert_allclose(_live_rows(got, seg), _live_rows(want, seg), atol=ATOL, rtol=0)


def test_seg_block_dispatch_pads_unaligned_rows_like_jax():
    # the JAX dispatch pads T to a multiple of SEG_BLOCK; the port takes any
    # T as it is, and live rows get the same result
    b, h, t, d = 1, 2, 300, 16  # not a multiple of SEG_BLOCK
    q, k, v = _qkv(10, (b, h, t, d))
    seg = _runs(t, [0, 120, 260])[None]
    want = jfa._seg_block_dispatch(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(seg),
                                   interpret=True)
    got = tfa.seg_block_mha(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg))
    assert got.shape == want.shape == (b, h, t, d)
    np.testing.assert_allclose(_live_rows(got, seg), _live_rows(want, seg), atol=ATOL, rtol=0)


def test_seg_block_dispatch_honours_a_folded_key_mask_like_jax():
    # the JAX dispatch folds the key mask into the ids; the port takes the
    # mask as its own operand: live rows see the same keys either way
    b, h, t, d = 1, 2, 256, 16
    q, k, v = _qkv(12, (b, h, t, d))
    seg = _runs(t, [0, 200])[None]
    mask = np.ones((b, t), bool)
    mask[0, 150:200] = False  # masked keys inside segment 1
    folded = np.where(mask, seg, 0)  # what the JAX mha computes before dispatch
    want = jfa._seg_block_dispatch(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(folded),
                                   interpret=True)
    got = tfa.seg_block_mha(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(seg),
                            key_mask=torch.from_numpy(mask))
    live = (seg > 0) & mask
    np.testing.assert_allclose(_live_rows(got, live), _live_rows(want, live), atol=ATOL, rtol=0)


def _record(monkeypatch, names):
    calls = []
    for name in names:
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _n=name, _f=fn, **k: calls.append(_n) or _f(*a, **k))
    return calls


@pytest.mark.parametrize("with_mask", [False, True], ids=["segments", "segments_and_mask"])
def test_mha_takes_the_extent_sparse_route_beyond_1024(monkeypatch, with_mask):
    # T=1152 with segments, not causal: the port routes to seg_block_mha
    # (the JAX dispatcher does on a TPU; on the CPU it takes its reference
    # path, which computes the same function)
    b, h, t, d = 1, 2, 1152, 16
    q, k, v = _qkv(11, (b, h, t, d))
    seg = _runs(t, [0, 300, 700, 1100])[None]
    kw = {"segment_ids": seg, "rope_base": 10000.0}
    live = seg > 0
    if with_mask:
        kw["key_mask"] = seg > 0
    calls = _record(monkeypatch, ["seg_block_mha", "grouped_mha", "flash_mha"])
    got = tfa.mha(*(torch.from_numpy(x) for x in (q, k, v)),
                  **{n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x
                     for n, x in kw.items()})
    assert calls == ["seg_block_mha"]
    want = jfa.mha(*(jnp.asarray(x) for x in (q, k, v)),
                   **{n: jnp.asarray(x) if isinstance(x, np.ndarray) else x
                      for n, x in kw.items()})
    np.testing.assert_allclose(_live_rows(got, live), _live_rows(want, live),
                               atol=ROPE_ATOL, rtol=0)


@pytest.mark.parametrize("t,kw,route", [
    (1152, {"causal": True}, "grouped_mha"),
    (1152, {"bias": True}, "grouped_mha"),
    (1152, {}, "seg_block_mha"),
    (1024, {}, "grouped_mha"),
])
def test_mha_routes_segmented_calls(monkeypatch, t, kw, route):
    calls = _record(monkeypatch, ["seg_block_mha", "grouped_mha", "flash_mha"])
    q = torch.zeros(1, 2, t, 16)
    if kw.pop("bias", False):
        kw["bias"] = torch.zeros(2, t)
    tfa.mha(q, q, q, segment_ids=torch.ones(1, t, dtype=torch.int32), **kw)
    assert calls == [route]


def test_seg_block_mha_has_no_path_for_other_devices_and_extents_need_whole_blocks():
    q = torch.zeros(1, 2, 64, 16)
    with pytest.raises(ValueError, match="no attention path"):
        tfa.seg_block_mha(q.to("meta"), q.to("meta"), q.to("meta"), torch.ones(1, 64))
    with pytest.raises(ValueError, match="not 2 blocks"):
        tfa._segment_block_extents(torch.ones(1, 200, dtype=torch.int32), 2, 128)


# ---- grouped_mha_bthd and mha_natural -------------------------------------

def _bthd_qkv(seed, b, t, h, d):
    return _qkv(seed, (b, t, h, d))


def _both_bthd(q, k, v, kw, **jax_kw):
    jkw = {n: jnp.asarray(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    tkw = {n: torch.from_numpy(x) if isinstance(x, np.ndarray) else x for n, x in kw.items()}
    want = np.asarray(jfa.grouped_mha_bthd(*(jnp.asarray(x) for x in (q, k, v)),
                                           interpret=True, **jax_kw, **jkw))
    got = tfa.grouped_mha_bthd(*(torch.from_numpy(x) for x in (q, k, v)), **tkw)
    assert got.shape == want.shape == q.shape
    return got.numpy(), want


def _mask_rows(t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


# name -> (B, T, H, D, keyword arguments, the JAX q-block, which rows to compare)
BTHD_CASES = {
    "padding": (2, 150, 4, 32, {"key_mask": _mask_rows(150, [110, 77])}, None, "mask"),
    "rope_multi_qblock": (1, 256, 2, 32, {"rope_base": 10000.0}, 128, "all"),
    "segmented": (2, 256, 4, 32, {"segment_ids": np.stack([_runs(256, [0, 100, 230]),
                                                           _runs(256, [0, 256])])}, 128, "seg"),
    "causal": (1, 256, 2, 32, {"causal": True}, 128, "all"),
    "causal_and_mask": (2, 128, 2, 16, {"causal": True, "key_mask": _mask_rows(128, [128, 90])},
                        64, "mask"),
    # T a multiple of 128: the TPU kernel pads nothing, so its all-masked row
    # averages v over exactly the T keys, as the plain version does
    "all_masked_row": (2, 128, 2, 16, {"key_mask": np.stack([np.ones(128, bool),
                                                             np.zeros(128, bool)])}, None, "all"),
}


@pytest.mark.parametrize("case", sorted(BTHD_CASES))
def test_grouped_mha_bthd_matches_jax_kernel(case):
    b, t, h, d, kw, block_q, rows = BTHD_CASES[case]
    q, k, v = _bthd_qkv(sorted(BTHD_CASES).index(case), b, t, h, d)
    got, want = _both_bthd(q, k, v, kw, block_q=block_q)
    atol = ROPE_ATOL if "rope_base" in kw else ATOL
    if rows == "mask":
        got, want = got[kw["key_mask"]], want[kw["key_mask"]]
    elif rows == "seg":
        got, want = got[kw["segment_ids"] > 0], want[kw["segment_ids"] > 0]
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_grouped_mha_bthd_masked_key_does_not_anchor_softmax_max():
    b, t, h, d = 1, 64, 2, 16
    q, k, v = _bthd_qkv(9, b, t, h, d)
    k[:, 50:] *= 100.0
    mask = np.ones((b, t), bool)
    mask[:, 50:] = False
    got, want = _both_bthd(q, k, v, {"key_mask": mask})
    np.testing.assert_allclose(got[mask], want[mask], atol=ATOL, rtol=0)


def test_grouped_mha_bthd_takes_no_bias():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(TypeError):
        tfa.grouped_mha_bthd(q, q, q, bias=torch.zeros(2, 8))


def test_mha_natural_matches_jax_transposed_mha():
    b, t, h, d = 2, 40, 4, 16
    q, k, v = _bthd_qkv(11, b, t, h, d)
    mask = _mask_rows(t, [40, 30])
    got = tfa.mha_natural(*(torch.from_numpy(x) for x in (q, k, v)),
                          key_mask=torch.from_numpy(mask), rope_base=10000.0)
    tr = lambda x: jnp.swapaxes(x, 1, 2)
    want = tr(jfa.mha(*(tr(jnp.asarray(x)) for x in (q, k, v)), key_mask=jnp.asarray(mask),
                      rope_base=10000.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("t,bias,route", [
    (256, False, "grouped_mha_bthd"),
    (1024, False, "grouped_mha_bthd"),
    (256, True, "mha"),
    (1025, False, "mha"),
])
def test_mha_natural_routes(monkeypatch, t, bias, route):
    calls = _record(monkeypatch, ["grouped_mha_bthd", "mha"])
    q = torch.zeros(1, t, 2, 16)
    out = tfa.mha_natural(q, q, q, bias=torch.zeros(2, t) if bias else None)
    assert calls == [route] and out.shape == q.shape


def test_cpu_calls_launch_no_kernel():
    q = torch.randn(1, 1152, 2, 16)
    seg = torch.from_numpy(_runs(1152, [0, 500, 1100]))[None]
    tfa.mha_natural(q, q, q, segment_ids=seg, key_mask=seg > 0)
    tfa.mha_natural(q[:, :256], q[:, :256], q[:, :256])
    assert set(tfa.LAUNCHES) == {"grouped_attention", "grouped_attention_bthd", "rope_qk",
                                 "flash_attention", "seg_block_attention"}
    assert all(n == 0 for n in tfa.LAUNCHES.values())
