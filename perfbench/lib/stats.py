"""Order statistics of a window's samples."""

from __future__ import annotations

import statistics


def percentile(values, pct: int) -> float:
    """The ``pct``-th percentile (1..99), interpolated between order
    statistics (``statistics.quantiles``, inclusive)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("no samples")
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=100, method="inclusive")[pct - 1]


def median(values) -> float:
    return float(statistics.median(values))
