"""Compensated reductions (``tpu_lbfgs.utils.accurate``): dot products whose
cross-chunk accumulation loses no bits, for ``LBFGSConfig(accurate_dots=True)``.

As in the reference, the chunk partials are plain sums in the working dtype
(one vectorised pass) and only the combine of the ``chunks`` partials is
compensated: that is where the magnitudes differ and the rounding loss
concentrates.  The reference combines them with a sequential Neumaier scan
of 1024 steps; in eager PyTorch that would be thousands of launches per dot.
The port combines them in a pairwise tree instead, log2(chunks) vectorised
levels, each an error-free TwoSum (Knuth): every level's rounding errors are
exact and are summed beside the partials, and the result is the tree's sum
plus the collected errors.  Both forms return the partials' sum to within a
few units of the last place of the working dtype; they differ from each
other by that much.  Nothing here loops over partials in Python or reads
the device.
"""
from __future__ import annotations

import torch
from torch import Tensor


def _compensated_sum(parts: Tensor) -> Tensor:
    """Error-compensated sum over the last axis."""
    n = parts.shape[-1]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        parts = torch.nn.functional.pad(parts, (0, size - n))
    comp = torch.zeros_like(parts)
    while size > 1:
        size //= 2
        a, b = parts[..., :size], parts[..., size:]
        t = a + b
        bv = t - a
        err = (a - (t - bv)) + (b - bv)      # exactly (a + b) - t
        comp = comp[..., :size] + comp[..., size:] + err
        parts = t
    return parts[..., 0] + comp[..., 0]


def compensated_dot(a: Tensor, b: Tensor, chunks: int = 1024) -> Tensor:
    """a . b over the last axis: vectorised chunk partials, compensated
    combine.  Leading axes are kept, so one call serves a stack of dots or
    a batch of lanes."""
    n = a.shape[-1]
    c = min(chunks, n)
    prod = a * b
    pad = (-n) % c
    if pad:
        prod = torch.nn.functional.pad(prod, (0, pad))
    parts = prod.reshape(prod.shape[:-1] + (c, -1)).sum(dim=-1)
    return _compensated_sum(parts)


def compensated_norm_sq(a: Tensor, chunks: int = 1024) -> Tensor:
    return compensated_dot(a, a, chunks)
