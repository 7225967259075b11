"""The pieces of the Hopper attention loop that run on the CPU: the pre-pass
(q and k rotated and scaled once per call) and the key-tile extents that
decide which key tiles each 128-query tile visits.

- ``plain_rope_qk`` followed by ``reference_mha(sm_scale=1)`` against the
  JAX ``grouped_mha`` in Pallas interpret mode, in bfloat16;
- ``_key_tile_extents`` against a brute-force numpy check: every (query,
  key) pair that the plain version lets a live row attend lies in its
  query tile's extent, on contiguous runs the extents are tight, and a
  row whose ids come back visits every tile;
- a plain emulation of the loop that drops the tiles outside the extents,
  and the tiles each 64-row warpgroup skips within them, equals
  ``plain_mha`` on live rows (every row for unsegmented causal calls).

The CUDA loop itself is compared with the plain version on the card in
tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.ops import flash_attention as jfa
from proteingym_tpu_torch.ops import flash_attention as tfa

# bf16 on both sides: the JAX kernel normalises after the p.v product and
# the plain version before it, so p is rounded to bf16 at other scales
# (2^-9 relative each) and the output once more; a masking, rotation or
# scale error is O(0.1-1)
BF16_TOL = 2e-2
F32_ATOL = 1e-5  # float32 on both sides: only summation order differs


def _lengths_mask(t, lengths):
    return np.arange(t)[None, :] < np.asarray(lengths)[:, None]


@pytest.mark.parametrize("d", [16, 24, 64])
@pytest.mark.parametrize("scale", [None, 1.0], ids=["default_scale", "prescaled"])
def test_prepass_then_reference_matches_jax_grouped_kernel_bf16(d, scale):
    b, h, t = 2, 3, 70
    rng = np.random.default_rng(d)
    q, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3))
    mask = _lengths_mask(t, [70, 41])
    bf = lambda x: torch.from_numpy(x).to(torch.bfloat16)
    jbf = lambda x: jnp.asarray(x, dtype=jnp.bfloat16)
    want = jfa.grouped_mha(jbf(q), jbf(k), jbf(v), key_mask=jnp.asarray(mask),
                           sm_scale=scale, rope_base=10000.0, interpret=True)
    sm = 1.0 / np.sqrt(d) if scale is None else scale
    qr, kr = tfa.plain_rope_qk(bf(q), bf(k), sm, 10000.0)
    assert qr.dtype == kr.dtype == torch.bfloat16
    got = tfa.reference_mha(qr, kr, bf(v), key_mask=torch.from_numpy(mask), sm_scale=1.0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=BF16_TOL, rtol=BF16_TOL)


def test_rope_qk_on_cpu_is_its_plain_version_and_launches_nothing():
    rng = np.random.default_rng(1)
    q, k = (torch.from_numpy(rng.standard_normal((1, 2, 9, 16)).astype(np.float32))
            for _ in range(2))
    before = dict(tfa.LAUNCHES)
    got = tfa.rope_qk(q, k, 0.25, 10000.0)
    want = tfa.plain_rope_qk(q, k, 0.25, 10000.0)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
    assert tfa.LAUNCHES == before
    # no rotation: k passes through untouched, q is only scaled
    qs, ks = tfa.rope_qk(q, k, 0.5)
    assert ks is k and torch.equal(qs, q * 0.5)


def _runs(b, t, rng, n_max=6, tail=True):
    """(b, t) int32 contiguous segment runs 1..n of random lengths, then a
    padding run (segment 0) when ``tail``."""
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        end = t - rng.integers(1, max(2, t // 8)) if tail else t
        cuts = np.sort(rng.choice(np.arange(1, end), min(n_max, end - 1) - 1, replace=False))
        for s_id, (lo, hi) in enumerate(zip([0, *cuts], [*cuts, end]), start=1):
            seg[i, lo:hi] = s_id
    return seg


def _split_runs(seg):
    """Make ids come back in rows 0 and 1 of contiguous runs, in place:
    row 0's last run takes the first run's id (one id, two runs far
    apart), row 1's second run swaps ids with its third (ids that fall)."""
    last = seg[0][seg[0] > 0].max()
    seg[0][seg[0] == last] = 1
    two, three = seg[1] == 2, seg[1] == 3
    seg[1][two], seg[1][three] = 3, 2


def _allowed(b, t, seg=None, mask=None, causal=False):
    """(B, T, T) bool: query i may attend key j in the plain version (a
    live key of its own segment, at or before it when causal)."""
    ok = np.ones((b, t, t), bool)
    if seg is not None:
        ok &= seg[:, :, None] == seg[:, None, :]
    if mask is not None:
        ok &= mask[:, None, :]
    if causal:
        ok &= np.tril(np.ones((t, t), bool))[None]
    return ok


def _extents(b, t, seg, mask, causal):
    ext = tfa._key_tile_extents(b, t, None if seg is None else torch.from_numpy(seg),
                                None if mask is None else torch.from_numpy(mask), causal, "cpu")
    return tuple(x.numpy() for x in ext)


def _packed_runs(b, t, rng, n=16, length=250):
    """(b, t) int32: ``n`` segments of about ``length`` tokens, each batch
    row its own cuts, then padding (ESM's segment-packed rows)."""
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        ends = np.cumsum(length + rng.integers(-20, 6, n))
        for s_id, (lo, hi) in enumerate(zip([0, *ends[:-1]], ends), start=1):
            seg[i, lo:hi] = s_id
    return seg


EXTENT_CASES = {  # name -> (T, segmented, key mask, causal)
    "segments_T77": (77, True, False, False),
    "segments_T300": (300, True, False, False),
    "segments_T1000": (1000, True, False, False),
    "segments_causal_T300": (300, True, False, True),
    "segments_causal_T4352": (4352, True, False, True),
    "segments_mask_T300": (300, True, True, False),
    "segments_split_runs_T300": (300, "split", False, False),
    "segments_split_runs_causal_T1037": (1037, "split", False, True),
    "causal_T256": (256, False, False, True),
    "causal_mask_dead_rows_T1037": (1037, False, True, True),
    # K2's main-path shape: each row its own valid length, one row whose
    # first keys are masked
    "k2_causal_mask_T4352": (4352, False, True, True),
    # K3's main-path shape: 16 x ~250 with each row's own cuts, the mask
    # unfolded (with a hole inside a segment)
    "k3_packed_segments_mask_T4096": (4096, "packed", True, False),
}


@pytest.mark.parametrize("case", sorted(EXTENT_CASES))
def test_extents_cover_every_live_pair_and_are_tight(case):
    t, segmented, masked, causal = EXTENT_CASES[case]
    rng = np.random.default_rng(sorted(EXTENT_CASES).index(case))
    b = 3
    if segmented == "packed":
        seg = _packed_runs(b, t, rng)
    else:
        seg = _runs(b, t, rng, n_max=16 if t > 1000 else 6) if segmented else None
    split = segmented == "split"
    if split:
        _split_runs(seg)
    mask = None
    if masked:
        mask = seg > 0 if segmented else _lengths_mask(t, [t, t - 5 - t // 10, t - 3])
        if segmented:
            mask[1, 300:320] = False  # keys inside a segment
        else:
            mask[2, :200] = False  # rows 0..199 of batch row 2 see no live key
    lo, hi = _extents(b, t, seg, mask, causal)
    n_qt, n_kt = -(-t // tfa.Q_TILE), -(-t // tfa.KERNEL_TILE)
    assert lo.shape == hi.shape == (b, n_qt) and lo.dtype == hi.dtype == np.int32
    ok = _allowed(b, t, seg, mask, causal)
    rows = np.arange(t)
    for bi in range(b):
        live = seg[bi] > 0 if segmented else np.ones(t, bool)
        for qt in range(n_qt):
            r = rows[qt * tfa.Q_TILE:(qt + 1) * tfa.Q_TILE]
            tiles = np.nonzero(ok[bi, r[live[r]]].any(axis=0))[0] // tfa.KERNEL_TILE
            if tiles.size:
                assert lo[bi, qt] <= tiles.min() and tiles.max() < hi[bi, qt], (bi, qt)
            dead = live[r] & ~ok[bi, r].any(axis=1)
            if dead.any() and not segmented:  # averaged over all T keys by the plain version
                assert (lo[bi, qt], hi[bi, qt]) == (0, n_kt), (bi, qt)
            if split and bi < 2:  # an id comes back: every tile up to the diagonal
                diag = (min(t, (qt + 1) * tfa.Q_TILE) - 1) // tfa.KERNEL_TILE + 1
                assert (lo[bi, qt], hi[bi, qt]) == (0, diag if causal else n_kt), (bi, qt)
            elif not masked:
                # contiguous runs, every row's own segment: the extent is
                # exactly the tiles the tile's rows (padding rows too) attend
                all_tiles = np.nonzero(ok[bi, r].any(axis=0))[0] // tfa.KERNEL_TILE
                assert (lo[bi, qt], hi[bi, qt]) == (all_tiles.min(), all_tiles.max() + 1)


def test_no_extents_without_segments_or_causal():
    assert tfa._key_tile_extents(2, 300, None, torch.ones(2, 300, dtype=torch.bool), False,
                                 "cpu") is None


def _allowed_t(b, t, key_mask=None, causal=False, segment_ids=None):
    """(B, T, T) bool: the pairs the plain version does not fill (torch)."""
    ok = torch.ones(b, t, t, dtype=torch.bool)
    if key_mask is not None:
        ok &= key_mask[:, None, :]
    if segment_ids is not None:
        ok &= segment_ids[:, :, None] == segment_ids[:, None, :]
    if causal:
        ok &= torch.ones(t, t, dtype=torch.bool).tril()
    return ok


def _visited(b, t, lo, hi, key_mask=None, causal=False, segment_ids=None):
    """(B, T, n_kt) bool: the key tiles whose products each query row's
    warpgroup runs in the Hopper loop, and the number of (warpgroup, tile)
    pairs skipped inside the extents. Within its block's extents
    [lo, hi), in order, a warpgroup of 64 rows skips a tile
    - whose key ids [min, max] miss the ids of its rows below T, or
    - that lies wholly in its rows' future (causal), unless one of its rows
      has met no key it may attend in the tiles it ran before (the vote at
      the first such tile)."""
    n_kt = -(-t // tfa.KERNEL_TILE)
    ok = _allowed_t(b, t, key_mask, causal, segment_ids)
    seg = None if segment_ids is None else segment_ids.long()
    out = torch.zeros(b, t, n_kt, dtype=torch.bool)
    skipped = 0
    for bi in range(b):
        for qt in range(lo.shape[1]):
            for r0 in range(qt * tfa.Q_TILE, min(t, (qt + 1) * tfa.Q_TILE), 64):
                rows = torch.arange(r0, min(r0 + 64, t))
                seen = torch.zeros(rows.numel(), dtype=torch.bool)
                vote = None
                for kt in range(int(lo[bi, qt]), int(hi[bi, qt])):
                    k0 = kt * tfa.KERNEL_TILE
                    keys = torch.arange(k0, k0 + tfa.KERNEL_TILE)
                    if seg is not None:
                        ids = torch.where(keys < t, seg[bi, keys.clamp(max=t - 1)], 0)
                        mine = seg[bi, rows]
                        if ids.max() < mine.min() or ids.min() > mine.max():
                            skipped += 1
                            continue
                    if causal and k0 > r0 + 63:
                        if vote is None:
                            vote = bool(seen.all())
                        if vote:
                            skipped += 1
                            continue
                    out[bi, rows, kt] = True
                    seen |= ok[bi][rows][:, keys[keys < t]].any(dim=1)
    return out, skipped


def _emulate(q, k, v, lo, hi, key_mask=None, bias=None, causal=False, segment_ids=None):
    """The Hopper loop's arithmetic in float64: each query row takes only
    the keys of the tiles its warpgroup runs (``_visited``; -inf outside
    them); masked pairs take the finite fill, as in the kernel. Returns the
    output and the number of warpgroup tiles skipped inside the extents."""
    b, h, t, d = q.shape
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / np.sqrt(d)
    if bias is not None:
        s = s + bias.double()[None, :, None, :]
    s = s.masked_fill(~_allowed_t(b, t, key_mask, causal, segment_ids)[:, None], tfa.NEG_INF)
    visited, skipped = _visited(b, t, lo, hi, key_mask, causal, segment_ids)
    key_tile = torch.arange(t) // tfa.KERNEL_TILE
    s = s.masked_fill(~visited[:, :, key_tile][:, None], float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v.double()).float()
    return out, skipped


EMULATION_CASES = {  # name -> (T, keyword arguments built from numpy)
    "segments_rows_of_packed_sequences": (700, "segments"),
    "segments_causal_poet_self_tier": (1100, "segments_causal"),
    "causal_with_dead_rows": (400, "causal_mask"),
    "causal_alibi": (300, "causal_alibi"),
    "segments_whose_ids_come_back": (700, "segments_split"),
    # 16 x ~250 per row, the key mask unfolded, with a hole in a segment
    "segments_and_an_unfolded_mask": (1300, "segments_packed"),
    # rows 384..459 of batch row 1 see no live key: the last query tile's
    # first warpgroup must run the tile in its future (all T keys)
    "causal_dead_rows_in_the_last_query_tile": (500, "causal_mask_late"),
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_dropping_the_skipped_tiles_equals_plain_on_live_rows(case):
    t, kind = EMULATION_CASES[case]
    b, h, d = 2, 2, 16
    rng = np.random.default_rng(7 + sorted(EMULATION_CASES).index(case))
    q, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d)).astype(np.float32))
               for _ in range(3))
    kw = {}
    if kind.startswith("segments"):
        if kind.endswith("packed"):
            seg = _packed_runs(b, t, rng, n=5)
            mask = seg > 0
            mask[0, 240:260] = False  # keys inside a segment
        else:
            seg = _runs(b, t, rng, n_max=12)
            if kind.endswith("split"):
                _split_runs(seg)
            mask = seg > 0
        kw = {"segment_ids": torch.from_numpy(seg), "key_mask": torch.from_numpy(mask),
              "causal": kind.endswith("causal")}
        live = torch.from_numpy(seg > 0)
    else:
        kw = {"causal": True}
        if kind.startswith("causal_mask"):
            mask = _lengths_mask(t, [t, t - 30])
            mask[1, :150 if kind == "causal_mask" else 460] = False  # rows with no live key
            kw["key_mask"] = torch.from_numpy(mask)
        else:
            slopes = 2.0 ** (-8.0 * np.arange(1, h + 1) / h)
            kw["bias"] = torch.from_numpy((slopes[:, None] * np.arange(t)[None]).astype(np.float32))
        live = torch.ones(b, t, dtype=torch.bool)
    lo, hi = tfa._key_tile_extents(b, t, kw.get("segment_ids"), kw.get("key_mask"),
                                   kw["causal"], "cpu")
    if not kind.endswith("split"):
        assert (hi - lo).float().mean() < -(-t // tfa.KERNEL_TILE)  # some tiles are skipped
    got, skipped = _emulate(q, k, v, lo, hi, **kw)
    if kind != "segments_split":
        assert skipped > 0  # warpgroups skip tiles inside their blocks' extents
    want = tfa.plain_mha(q, k, v, **kw)
    tr = lambda x: x.transpose(1, 2)[live]
    np.testing.assert_allclose(tr(got).numpy(), tr(want).numpy(), atol=F32_ATOL, rtol=0)


def test_key_tiles_find_the_extents_once_for_their_masks():
    seg = torch.from_numpy(_runs(2, 300, np.random.default_rng(3)))
    tiles = tfa.KeyTiles(seg, causal=True)
    first = tiles.extents(2, 300, "cpu")
    want = tfa._key_tile_extents(2, 300, seg, None, True, "cpu")
    assert all(torch.equal(a, w) for a, w in zip(first, want))
    assert tiles.extents(2, 300, "cpu") is first  # the next layers reuse them
    assert tfa.KeyTiles(seg).extents(2, 300, "cpu") is not None
    assert tfa.KeyTiles(key_mask=seg > 0).extents(2, 300, "cpu") is None
    tiles.check(seg, None, True)
    q = torch.zeros(2, 2, 300, 16)
    for other in (dict(segment_ids=seg.clone(), causal=True),
                  dict(segment_ids=seg, causal=False),
                  dict(segment_ids=seg, key_mask=seg > 0, causal=True)):
        with pytest.raises(ValueError, match="key_tiles were made for other"):
            tfa.grouped_mha(q, q, q, key_tiles=tiles, **other)
        with pytest.raises(ValueError, match="key_tiles were made for other"):
            tfa.grouped_mha_bthd(*(q.transpose(1, 2),) * 3, key_tiles=tiles, **other)
