"""The arithmetic of the end-to-end metrics: rates over a whole window and
tails over every request in it, never medians of windows."""

from __future__ import annotations

import math


def rate(work: float, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0.0:
        raise ValueError(f"a window of {seconds} s")
    return work / seconds


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of every value: the
    smallest value with at least q % of the values at or below it, so one
    stalled batch among few enough moves it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    return vals[max(math.ceil(q / 100.0 * len(vals)) - 1, 0)]
