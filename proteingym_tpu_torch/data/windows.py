"""Long-sequence windowing (counterpart of proteingym_tpu/data/windows.py).

Scores are only comparable to the published leaderboards if the window
math matches exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def get_optimal_window(
    mutation_position_relative: int, seq_len_wo_special: int, model_window: int
) -> Tuple[int, int]:
    """Half-open [start, end) window of width <= model_window around a
    position, including the reference quirk that the interior case has
    width ``2 * (model_window // 2)`` (one short when the window is odd)."""
    half = model_window // 2
    if seq_len_wo_special <= model_window:
        return (0, seq_len_wo_special)
    if mutation_position_relative < half:
        return (0, model_window)
    if mutation_position_relative >= seq_len_wo_special - half:
        return (seq_len_wo_special - model_window, seq_len_wo_special)
    return (
        max(0, mutation_position_relative - half),
        min(seq_len_wo_special, mutation_position_relative + half),
    )


def mutation_barycenter(positions_0idx) -> int:
    """Center of mass of the 0-indexed mutated positions, rounded down
    (the mean, int-cast, as ref tranception/utils/scoring_utils.py:170-171)."""
    return int(np.mean(np.asarray(positions_0idx, dtype=np.float64)))
