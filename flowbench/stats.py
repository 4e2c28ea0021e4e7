"""The percentile every metric uses, stated once."""
from __future__ import annotations

from typing import Sequence


def percentile(values: Sequence[float], p: float) -> float:
    """The p-th percentile (0-100), linear between closest ranks (numpy's
    default): rank (n - 1) * p / 100."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    r = (len(xs) - 1) * p / 100.0
    lo = int(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)

