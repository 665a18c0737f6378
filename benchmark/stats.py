"""Order statistics and interval arithmetic of the benchmark."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile (0 <= p <= 100) of all `values`, linearly
    interpolated between the two nearest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * p / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def median(values: Sequence[float]) -> float:
    return statistics.median(values)


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length of the union of `intervals`."""
    return sum(b - a for a, b in union(intervals))
