"""The arithmetic of the end-to-end metrics, on host timings."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q`` percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def rate(amount: float, t_start: float, t_end: float) -> float:
    """``amount`` over the wall seconds from ``t_start`` to ``t_end``: all
    the work of a window over all of its time."""
    if t_end <= t_start:
        raise ValueError("a window must have a positive length")
    return amount / (t_end - t_start)
