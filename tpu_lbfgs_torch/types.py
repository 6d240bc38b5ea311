"""Solver state and result containers, with the codes and names of
``tpu_lbfgs.types``.

The state is a dataclass of tensors on one device.  The curvature history
is a flat, contiguous ``(m, d)`` ring: the reference's ``(m, R, 128)``
row tiling (``tpu_lbfgs.types.hist_block``) only works around the TPU's
sublane padding and has no purpose on a GPU.  ``interop`` converts between
the two layouts.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import Tensor


class Status:
    """Solver status codes (carried on the device as int32)."""

    RUNNING = 0
    CONVERGED = 1
    LINE_SEARCH_FAILED = 2
    MAX_ITERS = 3

    NAMES = {0: "running", 1: "converged", 2: "line_search_failed", 3: "max_iters"}


class Guard:
    """Indices into the ``guards`` counter vector: how often each safeguard
    fired (see ``tpu_lbfgs.types.Guard``)."""

    DIR_FALLBACK = 0
    NOT_DESCENT = 1
    PAIR_REJECT = 2
    LS_RESCUE = 3
    LANE_FREEZE = 4
    DAMPED = 5
    N = 6

    NAMES = ("dir_fallback", "not_descent", "pair_reject", "ls_rescue",
             "lane_freeze", "damped")


@dataclasses.dataclass
class LBFGSState:
    """Full solver state.  Pair ``p`` (0-based over accepted pairs) lives in
    ring slot ``p % m``; ``hist_len = min(n_pairs, m)``.  Scalars are 0-d
    tensors on the state's device, so an iteration never reads them back to
    the host."""

    x: Tensor          # (d,)
    f: Tensor          # ()
    g: Tensor          # (d,)
    g_norm: Tensor     # ()
    s_hist: Tensor     # (m, d) s_p = x_{p+1} - x_p, ring-indexed
    y_hist: Tensor     # (m, d) y_p = g_{p+1} - g_p, ring-indexed
    sy_hist: Tensor    # (m,)
    yy_hist: Tensor    # (m,)
    SY: Tensor         # (m, m) s_i . y_j, physical slot order
    YY: Tensor         # (m, m) y_i . y_j
    Sg: Tensor         # (m,)   s_i . g
    Yg: Tensor         # (m,)   y_i . g
    n_pairs: Tensor    # () int32
    k: Tensor          # () int32
    status: Tensor     # () int32
    alpha: Tensor      # ()
    n_fev: Tensor      # () int32
    n_gev: Tensor      # () int32
    guards: Tensor     # (Guard.N,) int32

    @property
    def hist_len(self) -> Tensor:
        return torch.clamp(self.n_pairs, max=self.s_hist.shape[0])

    def replace(self, **kw) -> "LBFGSState":
        return dataclasses.replace(self, **kw)


class LineSearchResult(NamedTuple):
    alpha: Tensor
    n_fev: Tensor
    n_gev: Tensor
    rescued: Tensor


class SolveResult(NamedTuple):
    x: Tensor
    f: Tensor
    g_norm: Tensor
    iterations: Tensor
    status: Tensor
    n_fev: Tensor
    n_gev: Tensor
    # Per-iteration traces (cfg.record_trace) are not ported yet; the field
    # keeps the reference's result layout.
    trace: Optional[object] = None
    guards: Optional[Tensor] = None
