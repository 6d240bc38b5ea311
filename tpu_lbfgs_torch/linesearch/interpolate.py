"""Interpolation helpers of the line searches
(``tpu_lbfgs.linesearch.interpolate``), in the same formulas and order of
operations.

All take 0-d tensors (or tensors of one shape) and are branchless
(``torch.where``), so they run on the device with no host read.  They give
NaN wherever the reference gives NaN: the square root of a negative
discriminant is NaN, and the raw cubic passes it on.

Fidelity traps 4 and 5 (see ``strategies``): ``cubic_interpolate`` selects
the cubic's maximizer root and ``quadratic_interpolate`` mixes its anchor
points, as the reference's C++ does; the ``*_fixed`` variants are the
textbook formulas, used under ``cfg.fidelity == "fixed"``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def _sqrt(v: Tensor) -> Tensor:
    """The correctly rounded square root, as XLA's, numpy's and CUDA's.
    PyTorch's CPU sqrt is off by an ulp for about 1% of inputs; a CPU
    tensor goes through numpy instead (a 0-d search scalar costs nothing
    to convert)."""
    if v.device.type != "cpu":
        return torch.sqrt(v)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(v.numpy())))


def _copysign(a: Tensor, b: Tensor) -> Tensor:
    """|a| with the sign of b, as the reference writes it: +|a| for
    b == -0.0, where ``torch.copysign`` would give -|a|."""
    return torch.where(b < 0, -torch.abs(a), torch.abs(a))


def cubic_interpolate(a0: Tensor, a1: Tensor, p0: Tensor, dp0: Tensor,
                      p1: Tensor, dp1: Tensor) -> Tensor:
    """The reference's cubic through (a0, p0, dp0), (a1, p1, dp1); its
    maximizer root (fidelity trap 4).  May return NaN."""
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / (a1 - a0)
    d2 = _copysign(_sqrt(d1 * d1 - dp0 * dp1), a1 - a0)
    return a0 + (a1 - a0) * (dp0 + d2 - d1) / (dp0 - dp1 + 2.0 * d2)


def cubic_interpolate_fixed(a0: Tensor, a1: Tensor, p0: Tensor, dp0: Tensor,
                            p1: Tensor, dp1: Tensor) -> Tensor:
    """The textbook cubic minimizer (Nocedal & Wright eq. 3.59, anchored at
    a1).  May return NaN."""
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / (a1 - a0)
    d2 = _copysign(_sqrt(d1 * d1 - dp0 * dp1), a1 - a0)
    return a1 - (a1 - a0) * (dp1 + d2 - d1) / (dp1 - dp0 + 2.0 * d2)


def quadratic_interpolate(a0: Tensor, a1: Tensor, p0: Tensor, dp0: Tensor,
                          p1: Tensor) -> Tensor:
    """The reference's quadratic, called with (alpha, 0, f_new, dphi0, f_x):
    phi0 at the trial but dphi0 at 0 (fidelity trap 5)."""
    del a1
    return a0 - 0.5 * dp0 * a0 * a0 / (p1 - p0 - dp0 * a0)


def quadratic_interpolate_fixed(alpha: Tensor, p0: Tensor, dp0: Tensor,
                                p_alpha: Tensor) -> Tensor:
    """The textbook one-point quadratic minimizer through phi(0) = p0,
    phi'(0) = dp0, phi(alpha) = p_alpha (Nocedal & Wright eq. 3.58)."""
    return -0.5 * dp0 * alpha * alpha / (p_alpha - p0 - dp0 * alpha)


def safe_cubic_interpolate(a0: Tensor, a1: Tensor, p0: Tensor, dp0: Tensor,
                           p1: Tensor, dp1: Tensor,
                           denom_eps: float = 1e-10,
                           fixed: bool = False) -> Tensor:
    """The guarded cubic: swaps so that a0 < a1, falls back to the midpoint
    on a non-finite value, a negative discriminant or a small denominator,
    and clamps into the central 80% of [a0, a1].  ``fixed`` takes the
    textbook minimizer root under the same guards."""
    swap = a0 > a1
    a0, a1 = torch.where(swap, a1, a0), torch.where(swap, a0, a1)
    p0, p1 = torch.where(swap, p1, p0), torch.where(swap, p0, p1)
    dp0, dp1 = torch.where(swap, dp1, dp0), torch.where(swap, dp0, dp1)

    mid = 0.5 * (a0 + a1)
    span = a1 - a0

    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / span
    disc = d1 * d1 - dp0 * dp1
    d2 = _copysign(_sqrt(torch.clamp_min(disc, 0.0)), span)
    if fixed:
        denom = dp1 - dp0 + 2.0 * d2
        result = a1 - span * (dp1 + d2 - d1) / denom
    else:
        denom = dp0 - dp1 + 2.0 * d2
        result = a0 + span * (dp0 + d2 - d1) / denom

    bad = (~torch.isfinite(d1) | (disc < 0.0)
           | (torch.abs(denom) < denom_eps) | ~torch.isfinite(result))
    result = torch.where(bad, mid, result)
    # jnp.clip's order: the lower bound first, then the upper.
    return torch.minimum(torch.maximum(result, a0 + 0.1 * span),
                         a1 - 0.1 * span)
