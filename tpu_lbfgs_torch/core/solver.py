"""The L-BFGS solver loop (``tpu_lbfgs.core.solver``) in eager PyTorch.

One ``iterate`` is the reference's iteration, step for step: direction with
descent safeguard, line search, fused tail, masked ring write, incremental
history products, guard counters, state advance.  Every decision is a
tensor select on the device.  Under ``ls_eval="polynomial"`` with
``backtracking`` (bench.py's path) it reads nothing back to the host, so
the host only enqueues work; every other line search reads its loop
condition once per turn (``linesearch.strategies``).
``solve_from_state`` reads one scalar per iteration, the loop condition;
``solve_bounded`` reads none of its own.

The history ring is updated in place: ``iterate`` writes the new pair's
rows into ``state.s_hist`` / ``state.y_hist`` and hands the same tensors to
the returned state, which saves a copy of the (2, m, d) ring per iteration.
Keep no reference to an older state's ring.

Every function takes a state with an optional leading batch axis: x of
shape (B, d) gives a batched state (types.LBFGSState), which iterates all
B instances in lockstep, as ``jax.vmap`` of the reference's functions does.
Each lane takes its own decisions; a lane that has finished is left as it
is (``iterate`` is idempotent on finished lanes).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Tuple

import torch
from torch import Tensor

from ..config import LBFGSConfig, check_supported
from ..kernels.fused_ops import _vdot, fused_tail_plain
from ..linesearch.strategies import get_line_search
from ..types import Guard, LBFGSState, SolveResult, Status, per_lane
from .direction import compute_direction_with_aux

ObjFn = Callable[[Tensor], Tensor]
ValGradFn = Callable[[Tensor], Tuple[Tensor, Tensor]]


def init_state(vg: ValGradFn, x0: Tensor, m: int,
               history_dtype=None) -> LBFGSState:
    """The initial state; evaluates f and the gradient once at x0, which is
    (d,) or, for a batch of instances, (B, d).  The history keeps x0's
    dtype: "auto" resolves to it in the port (the reference's rule is a TPU
    VMEM-residency rule), and a history in another dtype is not ported
    yet."""
    dtype, dev = x0.dtype, x0.device
    if history_dtype == "bfloat16" or (history_dtype == "float32"
                                       and dtype != torch.float32):
        raise NotImplementedError(
            f"a {history_dtype} history for {dtype} iterates is not ported "
            "yet (ROADMAP.md Queue 1 item 8)")
    if x0.dim() not in (1, 2):
        raise ValueError(f"x0 must be (d,) or (B, d), got {tuple(x0.shape)}")
    lead, d = tuple(x0.shape[:-1]), x0.shape[-1]
    f0, g0 = vg(x0)

    # torch.full fills on the device; torch.tensor(v, device=...) would copy
    # from the host and wait for the copy.
    def full(shape, v, dt=dtype):
        return torch.full(lead + shape, v, dtype=dt, device=dev)

    i32 = torch.int32
    return LBFGSState(
        x=x0,
        f=f0,
        g=g0,
        g_norm=torch.sqrt(_vdot(g0, g0)),
        s_hist=full((m, d), 0.0),
        y_hist=full((m, d), 0.0),
        sy_hist=full((m,), 1.0),
        yy_hist=full((m,), 1.0),
        SY=full((m, m), 0.0),
        YY=full((m, m), 0.0),
        Sg=full((m,), 0.0),
        Yg=full((m,), 0.0),
        n_pairs=full((), 0, i32),
        k=full((), 0, i32),
        status=full((), Status.RUNNING, i32),
        alpha=full((), 0.0),
        n_fev=full((), 1, i32),
        n_gev=full((), 1, i32),
        guards=full((Guard.N,), 0, i32),
    )


def _polyval(coeffs: Tensor, a: Tensor) -> Tensor:
    """Horner evaluation, ascending coefficients on the last axis;
    coeffs[..., k] broadcasts against a."""
    cs = coeffs.unbind(-1)
    acc = cs[-1]
    for c in reversed(cs[:-1]):
        acc = acc * a + c
    return acc


def _polyder(coeffs: Tensor) -> Tensor:
    n = coeffs.shape[-1]
    return coeffs[..., 1:] * torch.arange(1, n, dtype=coeffs.dtype,
                                          device=coeffs.device)


def make_phi(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn, x: Tensor,
             d: Tensor, dir_poly=None, phi_batch=None, phi_dphi_batch=None):
    """phi / phi_dphi of the line search.

    ``ls_eval="polynomial"``: from the closed-form directional polynomial,
    one pass over (x, d) for the coefficients, then every trial is scalar
    Horner work.  The coefficients carry one row per lane, (..., n); phi of
    a (K,) batch of steps is (..., K).

    ``ls_eval="direct"`` (one instance): a trial is f(x + a d), a Wolfe
    trial vg(x + a d) and g_new . d, each a full pass.  A (K,) batch of
    trials, which the speculative searches ask for, goes through
    ``phi_batch`` / ``phi_dphi_batch`` (``problems.suite.multi_phi_for`` /
    ``multi_phi_dphi_for``: one pass for all K) when given, else trial by
    trial, as the reference's vmap does."""
    if cfg.ls_eval == "polynomial":
        if dir_poly is None:
            raise ValueError("ls_eval='polynomial' requires dir_poly "
                             "(see Problem.dir_poly)")
        coeffs = dir_poly(x, d)
        if coeffs.dim() > 1:
            coeffs = coeffs.unsqueeze(-2)

        def phi(a):
            return _polyval(coeffs, a)

        def phi_dphi(a):
            return _polyval(coeffs, a), _polyval(_polyder(coeffs), a)

        return phi, phi_dphi

    def one_dphi(a):
        f_new, g_new = vg(x + a * d)
        return f_new, _vdot(g_new, d)

    def phi(a):
        if a.dim() == 0:
            return f(x + a * d)
        if phi_batch is not None:
            return phi_batch(x, d, a)
        return torch.stack([f(x + aa * d) for aa in a.unbind(0)])

    def phi_dphi(a):
        if a.dim() == 0:
            return one_dphi(a)
        if phi_dphi_batch is not None:
            return phi_dphi_batch(x, d, a)
        fs, dphis = zip(*(one_dphi(aa) for aa in a.unbind(0)))
        return torch.stack(fs), torch.stack(dphis)

    return phi, phi_dphi


def _matvec(rows: Tensor, v: Tensor) -> Tensor:
    """rows (m, d) times v (d,), or per lane (B, m, d) times (B, d)."""
    if rows.dim() == 2:
        return torch.mv(rows, v)
    return torch.bmm(rows, v.unsqueeze(-1)).squeeze(-1)


def _keep_lanes(lanes: Tensor, new: LBFGSState,
                old: LBFGSState) -> LBFGSState:
    """new where lanes (B,) is True, old elsewhere, field by field."""
    kept = {}
    for f in dataclasses.fields(LBFGSState):
        a, b = getattr(new, f.name), getattr(old, f.name)
        if a is not b:     # the ring: iterate wrote it only for ``lanes``
            mask = lanes.reshape(lanes.shape + (1,) * (a.dim() - 1))
            kept[f.name] = torch.where(mask, a, b)
    return new.replace(**kept)


def iterate(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn, state: LBFGSState,
            dir_poly=None, fused_tail=None, phi_batch=None,
            phi_dphi_batch=None, lanes=None) -> LBFGSState:
    """One unconditional L-BFGS iteration (assumes status == RUNNING).
    ``fused_tail``: the post-line-search tail
    (problems.suite.fused_tail_for); without one the plain composition of
    ``vg`` runs.  ``phi_batch`` / ``phi_dphi_batch``: the K-trial
    evaluators of the speculative searches under ``ls_eval="direct"``
    (``make_phi``).  Updates the history ring in place (module docstring).

    ``lanes``: for a batched state, an optional (B,) bool mask.  A lane
    where it is False keeps every field, its ring rows included: the freeze
    that the reference's vmapped ``while_loop`` applies to a lane whose
    loop condition has failed."""
    check_supported(cfg)
    if state.x.dim() > 1 and (cfg.ls_eval == "direct"
                              or cfg.line_search != "backtracking"):
        raise NotImplementedError(
            f"a batched solve with ls_eval={cfg.ls_eval!r} and line_search="
            f"{cfg.line_search!r} is not ported to tpu_lbfgs_torch yet "
            "(ROADMAP.md Queue 1 item 7); batches run backtracking under "
            "ls_eval='polynomial'")
    if fused_tail is None:
        if cfg.use_pallas:
            raise NotImplementedError(
                "use_pallas without a fused tail selects the iteration_tail "
                "kernel, which is not ported yet (ROADMAP.md Queue 2 item "
                "1); pass fused_tail=fused_tail_for(...)")
        fused_tail = partial(fused_tail_plain, vg)
    m, dim = state.s_hist.shape[-2:]
    x, g = state.x, state.g

    # --- search direction with descent safeguard (lbfgs.cpp:147-153) --------
    d, aux, dir_fallback = compute_direction_with_aux(cfg, state)
    g_dot_d = aux.g_dot_d
    not_descent = g_dot_d >= 0
    d = torch.where(per_lane(not_descent), -g, d)
    g_dot_d = torch.where(not_descent, -state.g_norm * state.g_norm, g_dot_d)

    # --- line search -------------------------------------------------------
    phi, phi_dphi = make_phi(cfg, f, vg, x, d, dir_poly, phi_batch,
                             phi_dphi_batch)
    ls = get_line_search(cfg.line_search)(cfg, phi, phi_dphi, state.f,
                                          g_dot_d)
    alpha = ls.alpha

    # --- trial point, f/g there, pair and scalars, in one pass --------------
    step_failed = alpha < cfg.step_fail_tol
    (x_new, f_new, g_new, s_h, y_h, sy, yy, gg_new, dgn, _ggn, ygn,
     _t1, _t2) = fused_tail(x, d, alpha, g, state.s_hist, state.y_hist)

    failed = (step_failed | ~torch.isfinite(f_new) | ~torch.isfinite(gg_new)
              | (state.status != Status.RUNNING))
    store = ~failed & (sy > cfg.curvature_threshold)
    if lanes is not None:
        store = store & lanes

    # u1 = S y_new, u2 = Y y_new over the rows before the write below.
    u1 = _matvec(state.s_hist, y_h)
    u2 = _matvec(state.y_hist, y_h)

    # --- masked ring write: only each lane's slot row moves, only when
    # storing.  The ring's rows, (B*m, d), picked by integer index: a
    # boolean mask index would read the mask on the host. ------------------
    slot = state.n_pairs % m
    rows = slot.long().reshape(-1)
    if slot.dim():
        rows = rows + torch.arange(0, rows.numel() * m, m,
                                   device=rows.device)
    store_l = per_lane(store)
    for hist, row in ((state.s_hist, s_h), (state.y_hist, y_h)):
        flat = hist.view(-1, dim)
        keep = flat.index_select(0, rows)
        flat.index_copy_(0, rows, torch.where(store_l, row.view(-1, dim),
                                              keep))
    iota_m = torch.arange(m, dtype=slot.dtype, device=slot.device)
    is_slot = iota_m == per_lane(slot)
    sel = is_slot & store_l
    sy_l, yy_l = per_lane(sy), per_lane(yy)
    sy_hist = torch.where(sel, sy_l, state.sy_hist)
    yy_hist = torch.where(sel, yy_l, state.yy_hist)

    # --- incremental history products (direction="compact_incremental") ---
    # s_i.g_new = s_i.g + s_i.y (y = g_new - g); the slot's entries come
    # from the tail's exact sums.
    Sg_next = torch.where(sel, per_lane(alpha * dgn), state.Sg + u1)
    Yg_next = torch.where(sel, per_lane(ygn), state.Yg + u2)
    sy_col = torch.where(is_slot, sy_l, u1)
    yy_col = torch.where(is_slot, yy_l, u2)
    SY_next = torch.where(is_slot[..., None, :], sy_col[..., :, None],
                          state.SY)
    YY_next = torch.where(is_slot[..., None, :], yy_col[..., :, None],
                          state.YY)
    YY_next = torch.where(is_slot[..., :, None], yy_col[..., None, :],
                          YY_next)
    store_mat, failed_mat = per_lane(store, 2), per_lane(failed, 2)
    SY_next = torch.where(store_mat, SY_next, state.SY)
    YY_next = torch.where(store_mat, YY_next, state.YY)
    SY_next = torch.where(failed_mat, state.SY, SY_next)
    YY_next = torch.where(failed_mat, state.YY, YY_next)
    failed_vec = per_lane(failed)
    Sg_next = torch.where(failed_vec, state.Sg, Sg_next)
    Yg_next = torch.where(failed_vec, state.Yg, Yg_next)

    # --- safeguard counters (types.Guard), gated on RUNNING so that iterate
    # is idempotent on finished states -------------------------------------
    active = state.status == Status.RUNNING
    i32 = torch.int32
    counts = torch.stack([
        dir_fallback & (state.hist_len > 0),
        not_descent,
        ~failed & (sy <= cfg.curvature_threshold),
        ls.rescued.to(torch.bool),
        failed,
        torch.zeros_like(failed),      # Guard.DAMPED: damping is not ported
    ], dim=-1) & per_lane(active)
    guards = state.guards + counts.to(i32)

    active_i = active.to(i32)
    direct = cfg.ls_eval == "direct"
    new = LBFGSState(
        x=torch.where(failed_vec, x, x_new),
        f=torch.where(failed, state.f, f_new),
        g=torch.where(failed_vec, g, g_new),
        g_norm=torch.where(failed, state.g_norm, torch.sqrt(gg_new)),
        s_hist=state.s_hist,
        y_hist=state.y_hist,
        sy_hist=sy_hist,
        yy_hist=yy_hist,
        SY=SY_next,
        YY=YY_next,
        Sg=Sg_next,
        Yg=Yg_next,
        n_pairs=state.n_pairs + store.to(i32),
        k=state.k + active_i,
        status=torch.where(
            active,
            torch.where(failed, Status.LINE_SEARCH_FAILED, Status.RUNNING),
            state.status).to(i32),
        alpha=torch.where(active, alpha, state.alpha),
        # The tail's f and gradient, plus, in direct mode, the search's own
        # evaluations; in polynomial mode the trials are scalar work and one
        # f pass (the coefficients) is charged.
        n_fev=state.n_fev + (active_i * (1 + ls.n_fev) if direct
                             else 2 * active_i),
        n_gev=state.n_gev + (active_i * (1 + ls.n_gev) if direct
                             else active_i),
        guards=guards,
    )
    return new if lanes is None else _keep_lanes(lanes, new, state)


def _finalize_status(cfg: LBFGSConfig, state: LBFGSState) -> Tensor:
    """g_norm < tol wins over every other status (see the reference)."""
    return torch.where(
        state.g_norm < cfg.tol, Status.CONVERGED,
        torch.where(state.status != Status.RUNNING, state.status,
                    Status.MAX_ITERS)).to(torch.int32)


def _running(cfg: LBFGSConfig, state: LBFGSState) -> Tensor:
    return ((state.status == Status.RUNNING)
            & (state.g_norm >= cfg.tol)
            & (state.k < cfg.max_iters))


def solve_from_state(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                     state: LBFGSState, dir_poly=None, fused_tail=None,
                     phi_batch=None, phi_dphi_batch=None) -> LBFGSState:
    """Iterate while running; returns the final state with its status
    finalized.  Reads one scalar per iteration, the loop condition (for a
    batch: whether any lane still runs).  A lane stops the moment its own
    condition fails and keeps its state from then on, as under the
    reference's vmapped ``while_loop``."""
    check_supported(cfg)
    while True:
        running = _running(cfg, state)
        batched = running.dim() > 0
        if not bool(running.any() if batched else running):
            break
        state = iterate(cfg, f, vg, state, dir_poly, fused_tail, phi_batch,
                        phi_dphi_batch, lanes=running if batched else None)
    return state.replace(status=_finalize_status(cfg, state))


def solve_bounded(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                  state: LBFGSState, dir_poly=None, fused_tail=None,
                  phi_batch=None, phi_dphi_batch=None) -> LBFGSState:
    """Exactly ``cfg.max_iters`` more iterations with no read of the loop
    condition: safe because iterate is idempotent on finished states
    (lanes).  A state that would have converged early keeps iterating to
    the budget."""
    check_supported(cfg)
    for _ in range(cfg.max_iters):
        state = iterate(cfg, f, vg, state, dir_poly, fused_tail, phi_batch,
                        phi_dphi_batch)
    return state.replace(status=_finalize_status(cfg, state))


def _state_to_result(state: LBFGSState) -> SolveResult:
    return SolveResult(
        x=state.x, f=state.f, g_norm=state.g_norm, iterations=state.k,
        status=state.status, n_fev=state.n_fev, n_gev=state.n_gev,
        trace=None, guards=state.guards)


def make_value_and_grad(f: ObjFn, grad=None, value_and_grad=None) -> ValGradFn:
    """The objective interface: ``value_and_grad`` if given, else f with
    its analytic ``grad``."""
    if value_and_grad is not None:
        return value_and_grad
    if grad is not None:
        return lambda x: (f(x), grad(x))
    raise ValueError("tpu_lbfgs_torch needs an analytic gradient: pass "
                     "grad= or value_and_grad=")


def minimize(f: ObjFn, x0: Tensor, cfg: LBFGSConfig = LBFGSConfig(),
             grad=None, value_and_grad=None, dir_poly=None,
             fused_tail=None, phi_batch=None,
             phi_dphi_batch=None) -> SolveResult:
    """Solve from x0 on x0's device.  The entry point of the reference's
    ``tpu_lbfgs.minimize``, without its JAX-only arguments."""
    vg = make_value_and_grad(f, grad, value_and_grad)
    state = init_state(vg, x0, cfg.m, cfg.history_dtype)
    out = solve_from_state(cfg, f, vg, state, dir_poly, fused_tail,
                           phi_batch, phi_dphi_batch)
    return _state_to_result(out)
