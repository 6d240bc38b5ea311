"""The compensated stage 2 of the port's kernel sums, through its plain
mirror ``fused_ops.compensated_sum_plain`` (csrc/reduce.cuh::
finish_sums_compensated runs the same operations in the same order).

The mirror's 32 lanes each run the Neumaier recurrence over every 32nd
partial and fold their (sum, compensation) pairs by TwoSum, where the
kernels' first compensated stage 2 ran one recurrence over all partials in
block order.  Held to ``math.fsum`` (the correctly rounded sum) and to that
serial recurrence, each within one float64 unit in the last place of the
exact sum: the error bound of either is that rounding plus terms of order
n 2^-106 of the partials' magnitudes, below a unit here.
"""
import functools
import math
import operator

import numpy as np
import pytest

from tpu_lbfgs_torch.kernels.fused_ops import compensated_sum_plain

# Around one warp of lanes, one wave of 264 blocks, and the most partials a
# stage 2 takes.
COUNTS = (1, 2, 31, 32, 33, 264, 1024)


def _serial_neumaier(partials):
    """The first kernel's stage 2: one Neumaier recurrence in block
    order."""
    s = c = 0.0
    for p in map(float, partials):
        t = s + p
        c += (s - t) + p if abs(s) >= abs(p) else (p - t) + s
        s = t
    return s + c


def _partials(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "cancelling":
        # Magnitudes near 1e8 adding up to about 1: a plain float64 sum
        # keeps only the last eight digits of the answer.
        p = rng.standard_normal(n) * 1e8
        p[-1] = -math.fsum(p[:-1]) + rng.standard_normal()
        return p
    if kind == "mixed":
        return rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)
    return np.full(n, 0.1)         # all equal, none exact in binary


@pytest.mark.parametrize("with_comps", [False, True])
@pytest.mark.parametrize("kind", ["cancelling", "mixed", "equal"])
@pytest.mark.parametrize("n", COUNTS)
def test_compensated_stage2_mirror_is_accurate(n, kind, with_comps):
    partials = _partials(kind, n, seed=n)
    comps = None
    if with_comps:
        # Stage 1's compensations: a float64 remainder of each partial
        # (the float64 compensated iteration_tail keeps one per block).
        comps = partials * np.random.default_rng(n + 1).uniform(
            -2.0 ** -53, 2.0 ** -53, n)
    terms = list(partials) + ([] if comps is None else list(comps))
    exact = math.fsum(terms)
    unit = math.ulp(exact)
    got = compensated_sum_plain(partials, comps)
    assert abs(got - exact) <= unit, (got, exact)
    serial = _serial_neumaier(terms)
    assert abs(serial - exact) <= unit, (serial, exact)
    assert abs(got - serial) <= unit, (got, serial)
    # The order depends on the count alone: the same partials give the same
    # bits.
    assert compensated_sum_plain(partials, comps) == got


def test_compensated_stage2_mirror_recovers_what_a_plain_sum_drops():
    """[2^53, 1, -2^53] in every lane's order: a plain float64 sum gives 0,
    the compensated stage 2 the exact 1, at any count of lanes touched."""
    for reps in (1, 11, 341):
        partials = [2.0 ** 53, 1.0, -(2.0 ** 53)] * reps
        assert functools.reduce(operator.add, partials) != reps
        assert compensated_sum_plain(partials) == float(reps)
