"""The percentile and interval arithmetic."""

import numpy as np
import pytest

from h100bench import stats


@pytest.mark.parametrize("n", [1, 2, 7, 20, 201])
def test_p95_matches_numpy_linear(n):
    values = np.random.default_rng(n).random(n).tolist()
    assert stats.percentile(values, 0.95) == pytest.approx(np.percentile(values, 95), rel=1e-12)


def test_p95_with_ten_beyond():
    values = list(range(1, 201))  # 200 samples: 10 lie beyond the p95
    assert stats.percentile(values, 0.95) == pytest.approx(190.05)
    assert sum(v > stats.percentile(values, 0.95) for v in values) == 10


def test_union_gaps_and_cover():
    iv = [(5, 7), (0, 2), (1, 3), (10, 12), (6, 8), (11, 11)]
    assert stats.union(iv) == [(0, 3), (5, 8), (10, 12)]
    assert stats.covered(iv) == 3 + 3 + 2
    assert stats.gaps(iv, 0, 14) == [(3, 5), (8, 10), (12, 14)]
    assert stats.gaps(iv, 1, 6) == [(3, 5)]
    assert stats.clip(iv, 6, 11) == [(6, 7), (10, 11), (6, 8)]


def test_idle_share_from_union():
    busy = stats.covered(stats.clip([(0, 4), (2, 6), (8, 9)], 0, 10))
    assert 1 - busy / 10 == pytest.approx(0.3)
