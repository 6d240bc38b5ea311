"""The statistics a run reports."""
from __future__ import annotations

import math

#: Samples that have to lie beyond a reported percentile.
TAIL_SAMPLES = 10


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile of ``values``: the smallest value
    with at least q% of the samples at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("no samples")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def least_samples(q: float) -> int:
    """The fewest samples whose q-th percentile has ``TAIL_SAMPLES`` of
    them beyond it: 200 for the 95th."""
    return math.ceil(TAIL_SAMPLES / (1.0 - q / 100.0) - 1e-9)
