"""The CPU-side pieces of the sequence-weight kernel (K5,
``proteingym_tpu_torch/ops/csrc/cluster_counts.cu``) against the JAX
package:

- ``one_hot_nogap``, the plain version of the kernel's one-hot pre-pass
  (the layout the kernel reads, K padding included), against the JAX
  ``_one_hot_nogap`` value for value;
- an emulation of the kernel's schedule in torch: the tiles that the
  kernel's ``tile_of`` maps its linear tile indices onto (``_tile_of`` here
  follows it line by line), the per-pair rule (i < j counts for rows i and
  j, i == j once, i > j not at all), the mirrored row and column hits and
  the rows past N that the TMA unit fills with zeros, with int64 products
  per tile. It equals ``num_cluster_members_pallas(..., interpret=True)``
  and the plain version exactly;
- the mapping visits every tile that holds a pair i <= j once, and no
  other, in bands of row tiles that walk the column tiles in order.

The tile shape and band height are read from the kernel's source, so the
emulation follows the kernel if they change.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_cuda_kernels.py and by chip_smoke.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from proteingym_tpu.msa import weights as jweights
from proteingym_tpu_torch.msa import weights as tweights
from tests.test_torch_msa import COUNT_CASES, TIE_THETA, _family, _tie_alignment

SOURCE = (Path(tweights.__file__).resolve().parent.parent / "ops" / "csrc"
          / "cluster_counts.cu").read_text()


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


TR, TC, GROUP = _constant("kBM"), _constant("kBN"), _constant("kGroup")
RATIO = TC // TR


def _band_prefix(u, h):
    p = min(u, (h - 1) // RATIO)
    return RATIO * p * (p + 1) // 2 + (u - p) * h


def _band_rows(b, row_tiles):
    return min(GROUP, row_tiles - GROUP * b)


def _band_tiles(b, row_tiles, col_tiles):
    return _band_prefix(col_tiles - GROUP // RATIO * b, _band_rows(b, row_tiles))


def _sides(n):
    return -(-n // TR), -(-n // TC)


def _count_tiles(n):
    row_tiles, col_tiles = _sides(n)
    return sum(_band_tiles(b, row_tiles, col_tiles) for b in range(-(-row_tiles // GROUP)))


def _tile_of(t, n):
    """The kernel's tile_of: linear tile index -> (row tile, column tile)."""
    row_tiles, col_tiles = _sides(n)
    b = 0
    while t >= _band_tiles(b, row_tiles, col_tiles):
        t -= _band_tiles(b, row_tiles, col_tiles)
        b += 1
    h = _band_rows(b, row_tiles)
    p = (h - 1) // RATIO
    u = 0
    if t >= _band_prefix(p, h):
        u = p + (t - _band_prefix(p, h)) // h
    else:
        while _band_prefix(u + 1, h) <= t:
            u += 1
    return GROUP * b + t - _band_prefix(u, h), GROUP // RATIO * b + u


def _tiles(n):
    return [_tile_of(t, n) for t in range(_count_tiles(n))]


def test_one_hot_padding_is_the_kernels_stage_depth():
    assert tweights.K_ALIGN == _constant("kBK")


@pytest.mark.parametrize("length", [1, 5, 6, 7, 64, 300])
def test_one_hot_prepass_equals_jax_one_hot(length):
    m = _family(length, 9, length)
    m[0, :] = 21  # an indeterminate row: no channel set
    got = tweights.one_hot_nogap(torch.from_numpy(m).to(torch.int32))
    k = 20 * length
    assert got.dtype == torch.int8
    assert got.shape == (9, tweights.one_hot_depth(length))
    assert got.shape[1] % 128 == 0 and got.shape[1] - 128 < k <= got.shape[1]
    want = np.asarray(jweights._one_hot_nogap(jnp.asarray(m)), dtype=np.float32)
    np.testing.assert_array_equal(got[:, :k].numpy(), want.astype(np.int8))
    assert not got[:, k:].any()  # the K padding
    assert not got[0].any() and not got[2].any()  # code 21 and an all-gap row


def _emulate(m, identity):
    """The kernel's arithmetic on the CPU: every tile of ``_tiles`` on
    operands zero-filled past N, the thresholds past N read as 0 (as the
    kernel loads them), the hits it adds to rows and columns."""
    codes, l_non_gap, thr = tweights._prepare(m, identity, "cpu")
    n = codes.shape[0]
    rows = -(-n // TC) * TC
    oh = torch.zeros(rows, tweights.one_hot_depth(codes.shape[1]), dtype=torch.int64)
    oh[:n] = tweights.one_hot_nogap(codes).to(torch.int64)
    thr_p = torch.zeros(rows)
    thr_p[:n] = thr
    counts = torch.zeros(rows, dtype=torch.int64)
    for ti, tj in _tiles(n):
        i = torch.arange(ti * TR, ti * TR + TR)
        j = torch.arange(tj * TC, tj * TC + TC)
        matches = (oh[i] @ oh[j].T).float()  # exact: int64 products
        upper = i[:, None] <= j[None, :]
        row_hit = (j[None, :] < n) & upper & (matches > thr_p[i, None])
        col_hit = (i[:, None] < n) & upper & (i[:, None] != j[None, :]) & (
            matches > thr_p[None, j])
        counts.index_add_(0, i, row_hit.sum(1))
        # the drain adds a column's hits only below N
        counts.index_add_(0, j, torch.where(j < n, col_hit.sum(0), 0))
    counts = counts[:n].float()
    return torch.where(l_non_gap > 0, counts, torch.zeros_like(counts))


def _ties(n):
    """n rows cycling through the tie alignment's three rows: at TIE_THETA
    every pair of rows 0 and 1 is a float32 threshold tie, across tiles."""
    return _tie_alignment()[np.arange(n) % 3]


EMULATION_CASES = {  # name -> (alignment, theta)
    **COUNT_CASES,
    "one_row": lambda: (_family(4, 8, 30)[:1], 0.2),
    "one_past_a_row_tile": lambda: (_family(5, TR + 1, 9), 0.2),
    "one_past_a_column_tile": lambda: (_family(6, TC + 1, 7), 0.2),
    "neither_tile_side_divides_n": lambda: (_family(7, 389, 11), 0.2),
    "threshold_ties_across_tiles": lambda: (_ties(300), TIE_THETA),
}


@pytest.mark.parametrize("case", sorted(EMULATION_CASES))
def test_kernel_schedule_emulation_equals_jax_pallas_kernel(case):
    m, theta = EMULATION_CASES[case]()
    thr = 1.0 - theta
    tile = 16 if len(m) <= 64 else 128
    want = np.asarray(jweights.num_cluster_members_pallas(
        jnp.asarray(m), thr, tile_i=tile, tile_j=tile, tile_k=128, interpret=True))
    got = _emulate(m, thr).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tweights.num_cluster_members(m, thr).numpy())
    if case == "threshold_ties_across_tiles":
        assert set(want) == {100.0}  # each row counts only its copies: every tie is a miss


@pytest.mark.parametrize("row_tiles", range(1, 41))
def test_tile_mapping_visits_every_upper_tile_once(row_tiles):
    for n in {(row_tiles - 1) * TR + 1, row_tiles * TR}:  # a ragged and a full last tile
        listed = _tiles(n)
        assert len(set(listed)) == len(listed)  # once each
        span = lambda t, side: np.arange(t * side, min(t * side + side, n))
        upper = {(ti, tj) for ti in range(_sides(n)[0]) for tj in range(_sides(n)[1])
                 if np.any(span(ti, TR)[:, None] <= span(tj, TC)[None, :])}
        assert set(listed) == upper  # no tile without a pair i <= j
        # the tiles are disjoint, so they hold each pair i <= j < n once
        pairs = sum(int(np.sum(span(ti, TR)[:, None] <= span(tj, TC)[None, :]))
                    for ti, tj in listed)
        assert pairs == n * (n + 1) // 2
        # bands of GROUP row tiles, each walking the column tiles in order
        # with its rows side by side
        tiles = np.array(listed)
        band = tiles[:, 0] // GROUP
        assert np.all(np.diff(band) >= 0)
        for b in np.unique(band):
            by_column = [(int(tj), int(ti)) for ti, tj in tiles[band == b]]
            assert by_column == sorted(by_column)
