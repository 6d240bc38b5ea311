"""Search direction d = -H g by the incremental compact representation
(``tpu_lbfgs.core.direction``, ``direction="compact_incremental"``).

    H g = gamma g + [S, gamma Y] W [S'g; gamma Y'g]

The history products S'Y, Y'Y, S'g and Y'g are kept up to date in the state
by ``solver.iterate``, so the direction's only (m, d)-sized work is the
combine r = gamma g + v S - gamma u Y, two matrix-vector products, as the
reference leaves it to an XLA matmul (tpu_lbfgs/core/direction.py:215).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..kernels.chain import chain_torch
from ..types import LBFGSState


def _ring_logical_slots(n_pairs: Tensor, m: int) -> tuple[Tensor, Tensor]:
    """Physical slot of each logical index j (0 = oldest), and validity."""
    hist_len = torch.clamp(n_pairs, max=m)
    j = torch.arange(m, dtype=n_pairs.dtype, device=n_pairs.device)
    slots = (n_pairs - hist_len + j) % m
    valid = j < hist_len
    return slots, valid


def _gamma(state: LBFGSState, m: int) -> Tensor:
    """Initial Hessian scaling gamma = s'y / y'y of the newest pair, by an
    index gather of slot (n_pairs - 1) mod m."""
    newest = ((state.n_pairs - 1) % m).long().reshape(1)
    return state.sy_hist.index_select(0, newest)[0] \
        / state.yy_hist.index_select(0, newest)[0]


class DirAux(NamedTuple):
    """Coefficients with d = -(gamma g + v S - gamma u Y), and
    g_dot_d = g.d from the same coefficients in O(m).  On any fallback the
    triple is (1, 0, 0), i.e. d = -g."""
    gamma: Tensor
    v_phys: Tensor
    u_phys: Tensor
    g_dot_d: Tensor


def combine_direction(g: Tensor, s_hist: Tensor, y_hist: Tensor, v: Tensor,
                      u: Tensor, gamma: Tensor) -> Tensor:
    """r = gamma g + v S - gamma u Y over the (m, d) ring."""
    return gamma * g + torch.mv(s_hist.T, v) - gamma * torch.mv(y_hist.T, u)


def _compact_core(cfg: LBFGSConfig, state: LBFGSState, SY_p: Tensor,
                  YY_p: Tensor, Sg_p: Tensor, Yg_p: Tensor):
    m = state.s_hist.shape[0]
    g = state.g
    v_phys, u_phys, gamma, g_dot_d, fb_pre = chain_torch(
        SY_p, YY_p, Sg_p, Yg_p, state.sy_hist, state.yy_hist,
        state.n_pairs, state.g_norm, m, cfg.pair_skip_threshold)
    r_vec = combine_direction(g, state.s_hist, state.y_hist, v_phys, u_phys,
                              gamma)
    fallback = fb_pre | ~torch.all(torch.isfinite(r_vec))

    gg = state.g_norm * state.g_norm
    aux = DirAux(torch.where(fallback, 1.0, gamma),
                 torch.where(fallback, 0.0, v_phys),
                 torch.where(fallback, 0.0, u_phys),
                 torch.where(fallback, -gg, g_dot_d))
    return torch.where(fallback, -g, -r_vec), aux, fallback


def compact_incremental_direction_with_aux(cfg: LBFGSConfig,
                                           state: LBFGSState):
    """(d, DirAux, fallback) from the incrementally maintained products."""
    return _compact_core(cfg, state, state.SY, state.YY, state.Sg, state.Yg)


def compute_direction_with_aux(cfg: LBFGSConfig, state: LBFGSState):
    """(direction, DirAux, fallback_fired).  The port has only the
    incremental compact direction so far; ``check_supported`` rejects the
    others."""
    return compact_incremental_direction_with_aux(cfg, state)
