"""The arithmetic of the end-to-end metrics: rates over a whole window and
percentiles over every request in it."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(amount: float, seconds: float) -> float:
    """All of a window's work over all of its time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return amount / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, interpolated
    linearly between the two nearest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    at = (len(xs) - 1) * q / 100.0
    lo = math.floor(at)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (at - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
