"""The L-BFGS solver loop (``tpu_lbfgs.core.solver``) in eager PyTorch.

One ``iterate`` is the reference's iteration, step for step: direction with
descent safeguard, line search, fused tail, masked ring write, incremental
history products, guard counters, state advance.  It reads nothing back to
the host: every decision is a tensor select on the device, so the host only
enqueues work.  ``solve_from_state`` reads one scalar per iteration, the
loop condition; ``solve_bounded`` reads none.

The history ring is updated in place: ``iterate`` writes the new pair's
rows into ``state.s_hist`` / ``state.y_hist`` and hands the same tensors to
the returned state, which saves a copy of the (2, m, d) ring per iteration.
Keep no reference to an older state's ring.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import torch
from torch import Tensor

from ..config import LBFGSConfig, check_supported
from ..kernels.fused_ops import fused_tail_plain
from ..linesearch.strategies import backtracking
from ..types import Guard, LBFGSState, SolveResult, Status
from .direction import compute_direction_with_aux

ObjFn = Callable[[Tensor], Tensor]
ValGradFn = Callable[[Tensor], Tuple[Tensor, Tensor]]


def _scalar(v, dtype, device) -> Tensor:
    # torch.full fills on the device; torch.tensor(v, device=...) would copy
    # from the host and wait for the copy.
    return torch.full((), v, dtype=dtype, device=device)


def init_state(vg: ValGradFn, x0: Tensor, m: int,
               history_dtype=None) -> LBFGSState:
    """The initial state; evaluates f and the gradient once at x0.  The
    history keeps x0's dtype: "auto" resolves to it in the port (the
    reference's rule is a TPU VMEM-residency rule), and a history in
    another dtype is not ported yet."""
    dtype, dev = x0.dtype, x0.device
    if history_dtype == "bfloat16" or (history_dtype == "float32"
                                       and dtype != torch.float32):
        raise NotImplementedError(
            f"a {history_dtype} history for {dtype} iterates is not ported "
            "yet (ROADMAP.md Queue 1 item 8)")
    d = x0.shape[-1]
    f0, g0 = vg(x0)
    i32 = partial(_scalar, dtype=torch.int32, device=dev)
    return LBFGSState(
        x=x0,
        f=f0,
        g=g0,
        g_norm=torch.sqrt(torch.dot(g0, g0)),
        s_hist=torch.zeros((m, d), dtype=dtype, device=dev),
        y_hist=torch.zeros((m, d), dtype=dtype, device=dev),
        sy_hist=torch.ones(m, dtype=dtype, device=dev),
        yy_hist=torch.ones(m, dtype=dtype, device=dev),
        SY=torch.zeros((m, m), dtype=dtype, device=dev),
        YY=torch.zeros((m, m), dtype=dtype, device=dev),
        Sg=torch.zeros(m, dtype=dtype, device=dev),
        Yg=torch.zeros(m, dtype=dtype, device=dev),
        n_pairs=i32(0),
        k=i32(0),
        status=i32(Status.RUNNING),
        alpha=_scalar(0.0, dtype, dev),
        n_fev=i32(1),
        n_gev=i32(1),
        guards=torch.zeros(Guard.N, dtype=torch.int32, device=dev),
    )


def _polyval(coeffs: Tensor, a: Tensor) -> Tensor:
    """Horner evaluation, ascending coefficients; broadcasts over a."""
    n = coeffs.shape[0]
    acc = coeffs[n - 1]
    for k in range(n - 2, -1, -1):
        acc = acc * a + coeffs[k]
    return acc


def _polyder(coeffs: Tensor) -> Tensor:
    n = coeffs.shape[0]
    return coeffs[1:] * torch.arange(1, n, dtype=coeffs.dtype,
                                     device=coeffs.device)


def make_phi(x: Tensor, d: Tensor, dir_poly):
    """phi / phi_dphi of the line search from the closed-form directional
    polynomial (``ls_eval="polynomial"``): one pass over (x, d) for the
    coefficients, then every trial is scalar Horner work.  (The port has
    no other mode yet: ``check_supported`` rejects ``ls_eval="direct"``.)"""
    if dir_poly is None:
        raise ValueError("ls_eval='polynomial' requires dir_poly "
                         "(see Problem.dir_poly)")
    coeffs = dir_poly(x, d)
    dcoeffs = _polyder(coeffs)

    def phi(a):
        return _polyval(coeffs, a)

    def phi_dphi(a):
        return _polyval(coeffs, a), _polyval(dcoeffs, a)

    return phi, phi_dphi


def iterate(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn, state: LBFGSState,
            dir_poly=None, fused_tail=None) -> LBFGSState:
    """One unconditional L-BFGS iteration (assumes status == RUNNING), with
    no host read.  ``fused_tail``: the post-line-search tail
    (problems.suite.fused_tail_for); without one the plain composition of
    ``vg`` runs.  Updates the history ring in place (module docstring)."""
    del f   # polynomial line search: the objective is reached through vg
    check_supported(cfg)
    if fused_tail is None:
        if cfg.use_pallas:
            raise NotImplementedError(
                "use_pallas without a fused tail selects the iteration_tail "
                "kernel, which is not ported yet (ROADMAP.md Queue 2 item "
                "4); pass fused_tail=fused_tail_for(...)")
        fused_tail = partial(fused_tail_plain, vg)
    m = state.s_hist.shape[0]
    x, g = state.x, state.g

    # --- search direction with descent safeguard (lbfgs.cpp:147-153) --------
    d, aux, dir_fallback = compute_direction_with_aux(cfg, state)
    g_dot_d = aux.g_dot_d
    not_descent = g_dot_d >= 0
    d = torch.where(not_descent, -g, d)
    g_dot_d = torch.where(not_descent, -state.g_norm * state.g_norm, g_dot_d)

    # --- line search -------------------------------------------------------
    phi, phi_dphi = make_phi(x, d, dir_poly)
    ls = backtracking(cfg, phi, phi_dphi, state.f, g_dot_d)
    alpha = ls.alpha

    # --- trial point, f/g there, pair and scalars, in one pass --------------
    step_failed = alpha < cfg.step_fail_tol
    (x_new, f_new, g_new, s_h, y_h, sy, yy, gg_new, dgn, _ggn, ygn,
     _t1, _t2) = fused_tail(x, d, alpha, g, state.s_hist, state.y_hist)

    failed = (step_failed | ~torch.isfinite(f_new) | ~torch.isfinite(gg_new)
              | (state.status != Status.RUNNING))
    store = ~failed & (sy > cfg.curvature_threshold)

    # u1 = S y_new, u2 = Y y_new over the rows before the write below.
    u1 = torch.mv(state.s_hist, y_h)
    u2 = torch.mv(state.y_hist, y_h)

    # --- masked ring write: only the slot's row moves, only when storing ---
    slot = state.n_pairs % m
    slot1 = slot.long().reshape(1)
    for hist, row in ((state.s_hist, s_h), (state.y_hist, y_h)):
        keep = hist.index_select(0, slot1)
        hist.index_copy_(0, slot1, torch.where(store, row[None], keep))
    iota_m = torch.arange(m, dtype=slot.dtype, device=slot.device)
    is_slot = iota_m == slot
    sel = is_slot & store
    sy_hist = torch.where(sel, sy, state.sy_hist)
    yy_hist = torch.where(sel, yy, state.yy_hist)

    # --- incremental history products (direction="compact_incremental") ---
    # s_i.g_new = s_i.g + s_i.y (y = g_new - g); the slot's entries come
    # from the tail's exact sums.
    Sg_next = torch.where(sel, alpha * dgn, state.Sg + u1)
    Yg_next = torch.where(sel, ygn, state.Yg + u2)
    sy_col = torch.where(is_slot, sy, u1)
    yy_col = torch.where(is_slot, yy, u2)
    SY_next = torch.where(is_slot[None, :], sy_col[:, None], state.SY)
    YY_next = torch.where(is_slot[None, :], yy_col[:, None], state.YY)
    YY_next = torch.where(is_slot[:, None], yy_col[None, :], YY_next)
    SY_next = torch.where(store, SY_next, state.SY)
    YY_next = torch.where(store, YY_next, state.YY)
    SY_next = torch.where(failed, state.SY, SY_next)
    YY_next = torch.where(failed, state.YY, YY_next)
    Sg_next = torch.where(failed, state.Sg, Sg_next)
    Yg_next = torch.where(failed, state.Yg, Yg_next)

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
    ]) & active
    guards = state.guards + counts.to(i32)

    active_i = active.to(i32)
    return LBFGSState(
        x=torch.where(failed, x, x_new),
        f=torch.where(failed, state.f, f_new),
        g=torch.where(failed, g, g_new),
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
        # Polynomial mode: the search's trials are scalar work; one f pass
        # (the coefficients) plus the tail's f and gradient are charged.
        n_fev=state.n_fev + 2 * active_i,
        n_gev=state.n_gev + active_i,
        guards=guards,
    )


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
                     state: LBFGSState, dir_poly=None,
                     fused_tail=None) -> LBFGSState:
    """Iterate while running; returns the final state with its status
    finalized.  Reads one scalar per iteration, the loop condition."""
    check_supported(cfg)
    while bool(_running(cfg, state)):
        state = iterate(cfg, f, vg, state, dir_poly, fused_tail)
    return state.replace(status=_finalize_status(cfg, state))


def solve_bounded(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                  state: LBFGSState, dir_poly=None,
                  fused_tail=None) -> LBFGSState:
    """Exactly ``cfg.max_iters`` more iterations with no host read: safe
    because iterate is idempotent on finished states.  A state that would
    have converged early keeps iterating to the budget."""
    check_supported(cfg)
    for _ in range(cfg.max_iters):
        state = iterate(cfg, f, vg, state, dir_poly, fused_tail)
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
             fused_tail=None) -> SolveResult:
    """Solve from x0 on x0's device.  The entry point of the reference's
    ``tpu_lbfgs.minimize``, without its JAX-only arguments."""
    vg = make_value_and_grad(f, grad, value_and_grad)
    state = init_state(vg, x0, cfg.m, cfg.history_dtype)
    out = solve_from_state(cfg, f, vg, state, dir_poly, fused_tail)
    return _state_to_result(out)
