"""Search direction d = -H g by the incremental compact representation
(``tpu_lbfgs.core.direction``, ``direction="compact_incremental"``).

    H g = gamma g + [S, gamma Y] W [S'g; gamma Y'g]

The history products S'Y, Y'Y, S'g and Y'g are kept up to date in the state
by ``solver.iterate``, so the direction's only (m, d)-sized work is the
combine r = gamma g + v S - gamma u Y, two matrix-vector products, as the
reference leaves it to an XLA matmul (tpu_lbfgs/core/direction.py:215).

A batched state (leading axis B) runs the same code over (B, m, d) rings,
with the small-matrix head in the batched chain (kernels.chain
``compact_chain_batched``: the CUDA kernel on the card), where the
reference's ``custom_vmap`` rule runs its Pallas chain kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..kernels.chain import chain_torch, compact_chain_batched
from ..types import LBFGSState, per_lane


def _ring_logical_slots(n_pairs: Tensor, m: int) -> tuple[Tensor, Tensor]:
    """Physical slot of each logical index j (0 = oldest), and validity;
    (..., m) for n_pairs of shape (...)."""
    hist_len = torch.clamp(n_pairs, max=m)
    j = torch.arange(m, dtype=n_pairs.dtype, device=n_pairs.device)
    slots = (per_lane(n_pairs - hist_len) + j) % m
    valid = j < per_lane(hist_len)
    return slots, valid


def _newest_ratio(sy_hist: Tensor, yy_hist: Tensor, n_pairs: Tensor,
                  m: int) -> Tensor:
    """sy_hist / yy_hist at slot (n_pairs - 1) mod m of each lane, by an
    index gather (an index tensor with a dimension: a 0-d index would be
    read on the host)."""
    newest = ((n_pairs - 1) % m).long()[..., None]
    return (sy_hist.gather(-1, newest) / yy_hist.gather(-1, newest))[..., 0]


def _gamma(state: LBFGSState, m: int) -> Tensor:
    """Initial Hessian scaling gamma = s'y / y'y of the newest pair."""
    return _newest_ratio(state.sy_hist, state.yy_hist, state.n_pairs, m)


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
    """r = gamma g + v S - gamma u Y over the (m, d) ring, or per lane over
    a (B, m, d) ring."""
    if s_hist.dim() == 2:
        return gamma * g + torch.mv(s_hist.T, v) - gamma * torch.mv(
            y_hist.T, u)

    def rows(coef, hist):
        return torch.bmm(coef.unsqueeze(1), hist).squeeze(1)

    gamma = gamma.unsqueeze(-1)
    return gamma * g + rows(v, s_hist) - gamma * rows(u, y_hist)


def _compact_core(cfg: LBFGSConfig, state: LBFGSState, SY_p: Tensor,
                  YY_p: Tensor, Sg_p: Tensor, Yg_p: Tensor):
    m = state.s_hist.shape[-2]
    g = state.g
    chain = chain_torch if g.dim() == 1 else compact_chain_batched
    v_phys, u_phys, gamma, g_dot_d, fb_pre = chain(
        SY_p, YY_p, Sg_p, Yg_p, state.sy_hist, state.yy_hist,
        state.n_pairs, state.g_norm, m, cfg.pair_skip_threshold)
    r_vec = combine_direction(g, state.s_hist, state.y_hist, v_phys, u_phys,
                              gamma)
    fallback = fb_pre | ~torch.all(torch.isfinite(r_vec), dim=-1)

    gg = state.g_norm * state.g_norm
    fb_vec = per_lane(fallback)
    aux = DirAux(torch.where(fallback, 1.0, gamma),
                 torch.where(fb_vec, 0.0, v_phys),
                 torch.where(fb_vec, 0.0, u_phys),
                 torch.where(fallback, -gg, g_dot_d))
    return torch.where(fb_vec, -g, -r_vec), aux, fallback


def compact_incremental_direction_with_aux(cfg: LBFGSConfig,
                                           state: LBFGSState):
    """(d, DirAux, fallback) from the incrementally maintained products."""
    return _compact_core(cfg, state, state.SY, state.YY, state.Sg, state.Yg)


def compute_direction_with_aux(cfg: LBFGSConfig, state: LBFGSState):
    """(direction, DirAux, fallback_fired).  The port has only the
    incremental compact direction so far; ``check_supported`` rejects the
    others."""
    return compact_incremental_direction_with_aux(cfg, state)
