"""Search direction d = -H g from the limited-memory history
(``tpu_lbfgs.core.direction``), in the reference's three formulations.

``two_loop``
    The classic two-loop recursion over the ring: 2m sequential
    dot-and-axpy passes.  The reference's guards are selects on the device:
    a non-finite rho or a non-positive or non-finite gamma falls back to
    steepest descent; with ``cfg.pair_skip_threshold`` set, low-curvature
    pairs are skipped one by one instead.  Nothing is read on the host.

``compact`` and ``compact_incremental``
    The Byrd-Nocedal-Schnabel compact representation,

        H g = gamma g + [S, gamma Y] W [S'g; gamma Y'g]

    ``compact`` contracts the history products S'Y, Y'Y, S'g and Y'g anew
    every iteration (``history_products``); ``compact_incremental`` reads
    them from the state, where ``solver.iterate`` keeps them up to date, so
    its only (m, d)-sized work is the combine r = gamma g + v S - gamma u Y,
    two matrix-vector products, as the reference leaves it to an XLA matmul
    (tpu_lbfgs/core/direction.py:215).

A batched state (leading axis B) runs the same code over (B, m, d) rings,
with the small-matrix head in the batched chain (kernels.chain
``compact_chain_batched``: the CUDA kernel on the card), where the
reference's ``custom_vmap`` rule runs its Pallas chain kernel.

With a ``comm`` (``dist.comm.ShardComm``) the state is one shard of a
sharded solve: the ring holds this shard's columns, and every contraction
over d is a float64 partial finished by one all-reduce over the group: one
per dot of the two-loop, ONE for ``history_products``' packed (2m, m + 1)
block, and one flag for the combine's finiteness check, so that every rank
takes the same fallback.  The small-matrix chain and the combine are local.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..kernels.chain import chain_torch, compact_chain_batched
from ..kernels.fused_ops import _rdot, combine_direction
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
    read on the host).  The reference takes them as one-hot sums
    (tpu_lbfgs/core/direction.py:79-97), which XLA compiles to selects: a
    non-finite entry in another slot stays there, as with the gather (run
    eagerly, op by op, its 0 * NaN would spread)."""
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


def _compact_core(cfg: LBFGSConfig, state: LBFGSState, SY_p: Tensor,
                  YY_p: Tensor, Sg_p: Tensor, Yg_p: Tensor, comm=None):
    m = state.s_hist.shape[-2]
    g = state.g
    chain = chain_torch if g.dim() == 1 else compact_chain_batched
    v_phys, u_phys, gamma, g_dot_d, fb_pre = chain(
        SY_p, YY_p, Sg_p, Yg_p, state.sy_hist, state.yy_hist,
        state.n_pairs, state.g_norm, m, cfg.pair_skip_threshold)
    # The reference pins the combine to its matmul route inside the solver
    # (tpu_lbfgs/core/direction.py:215); so does the port.
    r_vec = combine_direction(g, state.s_hist, state.y_hist, v_phys, u_phys,
                              gamma, use_pallas=False)
    bad_r = ~torch.all(torch.isfinite(r_vec), dim=-1)
    if comm is not None:
        bad_r = comm.any_flag(bad_r)
    fallback = fb_pre | bad_r

    gg = state.g_norm * state.g_norm
    fb_vec = per_lane(fallback)
    aux = DirAux(torch.where(fallback, 1.0, gamma),
                 torch.where(fb_vec, 0.0, v_phys),
                 torch.where(fb_vec, 0.0, u_phys),
                 torch.where(fallback, -gg, g_dot_d))
    return torch.where(fb_vec, -g, -r_vec), aux, fallback


def _ring_row(hist: Tensor, slot: Tensor, dtype) -> Tensor:
    """Row ``slot`` of an (m, d) ring, or each lane's own row of a
    (B, m, d) ring, in ``dtype`` (a bfloat16 row is widened, as the
    reference's mixed-dtype dots and axpys promote it); ``slot`` is (1,) or
    (B, 1) int64.  An index tensor with a dimension: a 0-d index would be
    read on the host."""
    if hist.dim() == 2:
        row = hist.index_select(0, slot)[0]
    else:
        idx = slot[..., None].expand(-1, 1, hist.shape[-1])
        row = hist.gather(-2, idx)[..., 0, :]
    return row if row.dtype == dtype else row.to(dtype)


def _two_loop_core(cfg: LBFGSConfig, state: LBFGSState, comm=None):
    """(direction, fallback_fired) by the two-loop recursion; the bool
    feeds the Guard.DIR_FALLBACK counter."""
    m = state.s_hist.shape[-2]
    g = state.g
    slots, valid = _ring_logical_slots(state.n_pairs, m)
    slots = slots.long()
    sy = state.sy_hist.gather(-1, slots)           # logical order
    rho = 1.0 / sy

    if cfg.pair_skip_threshold is not None:
        # GPU semantics: skip low-curvature pairs one by one, never fall
        # back on rho.
        use = valid & (sy > cfg.pair_skip_threshold)
        bad_rho = torch.zeros_like(valid[..., 0])
    else:
        # CPU semantics: any non-finite rho among the stored pairs falls
        # back to steepest descent.
        use = valid
        bad_rho = torch.any(valid & ~torch.isfinite(rho), dim=-1)

    # First loop: newest -> oldest.
    q = g
    alphas = [None] * m
    for j in reversed(range(m)):
        slot = slots[..., j:j + 1]
        a = torch.where(use[..., j],
                        rho[..., j] * _rdot(
                            comm, _ring_row(state.s_hist, slot, g.dtype), q),
                        0.0)
        q = q - per_lane(a) * _ring_row(state.y_hist, slot, g.dtype)
        alphas[j] = a

    gamma = _gamma(state, m)
    bad_gamma = (gamma <= 0) | ~torch.isfinite(gamma)
    r_vec = per_lane(gamma) * q

    # Second loop: oldest -> newest.
    for j in range(m):
        slot = slots[..., j:j + 1]
        b = torch.where(use[..., j],
                        rho[..., j] * _rdot(
                            comm, _ring_row(state.y_hist, slot, g.dtype),
                            r_vec),
                        0.0)
        coeff = torch.where(use[..., j], alphas[j] - b, 0.0)
        r_vec = r_vec + per_lane(coeff) * _ring_row(state.s_hist, slot,
                                                    g.dtype)

    fallback = bad_rho | bad_gamma | (state.hist_len == 0)
    return torch.where(per_lane(fallback), -g, -r_vec), fallback


def two_loop_direction(cfg: LBFGSConfig, state: LBFGSState,
                       comm=None) -> Tensor:
    """d = -H g by the two-loop recursion over the ring."""
    return _two_loop_core(cfg, state, comm)[0]


def history_products(state: LBFGSState, comm=None):
    """The four history contractions (SY, YY, Sg, Yg) from the ring and the
    current gradient: what ``compact`` computes every iteration and
    ``solver.refresh_products`` between segments.  A ring in another dtype
    than the gradient's (bfloat16) is widened first: its products are exact
    and add up in the gradient's dtype.  Sharded, the four are float64
    partials over this shard's columns and cross the group as one packed
    block."""
    S, Y, g = state.s_hist, state.y_hist, state.g
    dtype = g.dtype if comm is None else torch.float64
    if S.dtype != dtype:
        S, Y = S.to(dtype), Y.to(dtype)
    if g.dtype != dtype:
        g = g.to(dtype)
    Yt = Y.transpose(-1, -2)
    gcol = g.unsqueeze(-1)
    prods = (torch.matmul(S, Yt), torch.matmul(Y, Yt),
             torch.matmul(S, gcol).squeeze(-1),
             torch.matmul(Y, gcol).squeeze(-1))
    if comm is None:
        return prods
    return tuple(comm.reduce_parts(prods, state.g.dtype))


def compact_direction_with_aux(cfg: LBFGSConfig, state: LBFGSState,
                               comm=None):
    """(d, DirAux, fallback) with the products recomputed from the ring."""
    return _compact_core(cfg, state, *history_products(state, comm),
                         comm=comm)


def compact_direction(cfg: LBFGSConfig, state: LBFGSState,
                      comm=None) -> Tensor:
    """d = -H g by the compact representation."""
    return compact_direction_with_aux(cfg, state, comm)[0]


def compact_incremental_direction_with_aux(cfg: LBFGSConfig,
                                           state: LBFGSState, comm=None):
    """(d, DirAux, fallback) from the incrementally maintained products."""
    return _compact_core(cfg, state, state.SY, state.YY, state.Sg, state.Yg,
                         comm=comm)


def compute_direction_with_aux(cfg: LBFGSConfig, state: LBFGSState,
                               comm=None):
    """(direction, DirAux or None, fallback_fired)."""
    if cfg.direction == "compact":
        return compact_direction_with_aux(cfg, state, comm)
    if cfg.direction == "compact_incremental":
        return compact_incremental_direction_with_aux(cfg, state, comm)
    d, fallback = _two_loop_core(cfg, state, comm)
    return d, None, fallback


def compute_direction(cfg: LBFGSConfig, state: LBFGSState,
                      comm=None) -> Tensor:
    return compute_direction_with_aux(cfg, state, comm)[0]
