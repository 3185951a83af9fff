"""Percentiles, spreads and open-loop latencies, on every sample of a window."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Sequence


def percentile(values: Iterable[float], q: float) -> float:
    """The q-th percentile (0-100) of all the values, interpolated
    linearly between closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def open_loop_latencies(due: Sequence[float], done: Sequence[float], wait_end: float) -> List[float]:
    """Each request's latency from the time it was due in the schedule,
    not from when it was sent: a stall delays every request behind it. A
    request with no completion (``None``: failed or never answered)
    counts as waiting until ``wait_end``."""
    return [(d if d is not None else wait_end) - t for t, d in zip(due, done)]

