"""Arithmetic of the end-to-end metrics: rates and percentiles."""

from __future__ import annotations

import math


def rate(count: float, seconds: float) -> float:
    """``count`` over ``seconds``: the work of the whole window over its whole time."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return count / seconds


def percentile(values, q: float) -> tuple[float, int]:
    """The ``q``-th percentile of ``values`` (nearest rank: the smallest value
    with at least ``q`` % of the values at or below it) and how many values
    lie beyond it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(xs)))
    v = xs[rank - 1]
    return v, sum(1 for x in xs if x > v)
