"""Order statistics of the benchmark, over every sample of a window."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all `values`, linear between the two
    nearest ranks (numpy's default rule)."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("no samples")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(count: float, seconds: float) -> float:
    """Work per second over a whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return count / seconds
