"""Arithmetic of the benchmark's readings: percentiles and unions of time
intervals. Pure Python, so that it reads the same everywhere."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q`` quantile (0..1) of ``values`` by linear interpolation
    between the order statistics (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The disjoint, sorted union of half-open intervals."""
    out: List[Interval] = []
    for start, end in sorted(intervals):
        if end <= start:
            continue
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


def clip(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``intervals`` inside [lo, hi)."""
    return [(max(s, lo), min(e, hi)) for s, e in intervals if min(e, hi) > max(s, lo)]


def covered(intervals: Iterable[Interval]) -> float:
    """The length that the union of ``intervals`` covers."""
    return sum(e - s for s, e in union(intervals))


def gaps(intervals: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi) that no interval covers, in order."""
    out, at = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out
