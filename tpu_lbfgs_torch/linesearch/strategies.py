"""Armijo backtracking (``tpu_lbfgs.linesearch.strategies.backtracking``)
with no host read.

The reference runs the search as a ``while_loop`` on the device: test
alpha, accept and stop, or shrink it and stop untested once it falls below
``backtracking_tol``.  In eager PyTorch each turn of that loop would read
its condition on the host.  Under ``ls_eval="polynomial"`` a trial costs
one scalar Horner evaluation, so the port tests the whole ladder
alpha_k = initial_step * shrink^k at once (27 trials at the defaults) and
picks the first accepted trial.  The ladder is built by the loop's own
repeated multiplication in the working dtype, and each trial runs the
loop's own comparison, so the accepted alpha is bit-identical to the
loop's.

Batched, ``f_x`` and ``g_dot_d`` carry one value per lane, ``(B,)``, and
``phi`` returns ``(B, K)``: each lane picks its own first accepted trial.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Callable

import numpy as np
import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..types import LineSearchResult, per_lane

_LADDER_CAP = 100_000


def _apply_rescue(cfg: LBFGSConfig, alpha: Tensor) -> tuple[Tensor, Tensor]:
    """Parallel-fidelity floor rescue: alpha < floor -> rescue value.
    Returns (alpha, fired) for the Guard.LS_RESCUE counter."""
    if cfg.alpha_rescue_floor is None:
        return alpha, torch.zeros_like(alpha, dtype=torch.int32)
    hit = alpha < cfg.alpha_rescue_floor
    return (torch.where(hit, cfg.alpha_rescue_value, alpha),
            hit.to(torch.int32))


def _armijo_accept(cfg: LBFGSConfig, f_x, f_new, alpha, g_dot_d) -> Tensor:
    if cfg.fidelity == "reference":
        # The reference's sign-flipped rule (line_search.cpp:24).
        return (f_x - f_new) >= cfg.c1 * alpha * g_dot_d
    return f_new <= f_x + cfg.c1 * alpha * g_dot_d


@lru_cache(maxsize=64)
def _ladder(initial_step: float, shrink: float, tol: float,
            dtype: torch.dtype, device: torch.device) -> tuple[Tensor, float]:
    """(trials, underflowed): every alpha the loop can test, on the device,
    and the untested alpha it returns when none is accepted.  Cached, so
    the host-to-device copy happens once per configuration and device."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    shrink_t, tol_t = np_dtype.type(shrink), np_dtype.type(tol)
    trials = [np_dtype.type(initial_step)]
    while True:
        nxt = trials[-1] * shrink_t
        if nxt < tol_t:
            break
        trials.append(nxt)
        if len(trials) > _LADDER_CAP:
            raise ValueError(f"backtracking never falls below "
                             f"backtracking_tol={tol} with shrink={shrink}")
    return (torch.tensor(np.array(trials, np_dtype), device=device),
            float(nxt))


def backtracking(cfg: LBFGSConfig, phi: Callable[[Tensor], Tensor],
                 phi_dphi, f_x: Tensor, g_dot_d: Tensor) -> LineSearchResult:
    """Armijo backtracking over the whole ladder at once; ``phi`` must take
    a (K,) ladder of step sizes and return (..., K), one row per lane."""
    del phi_dphi
    alphas, underflowed = _ladder(cfg.initial_step, cfg.shrink,
                                  cfg.backtracking_tol, f_x.dtype, f_x.device)
    accept = _armijo_accept(cfg, per_lane(f_x), phi(alphas), alphas,
                            per_lane(g_dot_d))
    accepted = torch.any(accept, dim=-1)
    first = torch.argmax(accept.to(torch.int32), dim=-1)
    # index_select on the flattened index: indexing with a 0-d tensor would
    # read it on the host.
    alpha = torch.where(accepted, alphas.index_select(0, first.reshape(-1))
                        .reshape(first.shape), underflowed)
    n_fev = torch.where(accepted, first.to(torch.int32) + 1,
                        alphas.shape[0])
    if cfg.fidelity == "fixed" and cfg.alpha_rescue_floor is None:
        # Textbook semantics: a search that never satisfied Armijo fails.
        alpha = torch.where(accepted, alpha, 0.0)
    alpha, rescued = _apply_rescue(cfg, alpha)
    return LineSearchResult(alpha, n_fev,
                            torch.zeros_like(n_fev), rescued)
