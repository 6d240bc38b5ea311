"""The L-BFGS solver loop (``tpu_lbfgs.core.solver``) in eager PyTorch.

One ``iterate`` is the reference's iteration, step for step: direction with
descent safeguard, line search, fused tail, masked ring write, incremental
history products, guard counters, state advance.  Every decision is a
tensor select on the device.  Under ``ls_eval="polynomial"`` with
``backtracking`` (bench.py's path) it reads nothing back to the host, so
the host only enqueues work; every other line search loops
(``linesearch.strategies``): inside a captured block each loop is a CUDA
graph WHILE node and nothing is read, else it reads its loop
condition once per turn, unless ``iterate`` is asked for the searches'
fixed-trip loop (``bounded=True``).
The solves run their iterations in blocks (``core.blocks``), replayed as
CUDA graphs on the card: ``solve_from_state``, ``make_solve_segment`` and
the traced solve read the loop's flags once per block,
``solve_bounded`` reads none, its searches' included.  A solve of a short
budget runs its blocks eagerly (``blocks.CAPTURE_MIN_ITERS``;
``blocks.GATED_CAPTURE_MIN_ITERS`` under a search that loops), and a
while form under a search that loops then keeps the per-iteration loop,
as do a sharded solve and ``set_debug_nans(True)``: one read of the
condition per iteration.

The history ring is updated in place: ``iterate`` writes the new pair's
rows into ``state.s_hist`` / ``state.y_hist`` and hands the same tensors to
the returned state, which saves a copy of the (2, m, d) ring per iteration.
Keep no reference to an older state's ring.

The solver's own tensor work runs under ``torch.no_grad()``: the ring's
in-place writes never enter an autograd graph, and a direct-mode trial
f(x + a d) builds none.  Only ``make_value_and_grad``'s autograd gradient
(an objective passed without ``grad``) records one, for the length of one
evaluation.

Every function takes a state with an optional leading batch axis: x of
shape (B, d) gives a batched state (types.LBFGSState), which iterates all
B instances in lockstep, as ``jax.vmap`` of the reference's functions does.
Each lane takes its own decisions; a lane that has finished is left as it
is (``iterate`` is idempotent on finished lanes).

``comm`` (``dist.comm.ShardComm``) makes the same code one shard of a
sharded solve: x, g and the ring hold this process's block of the vector
axis, one instance's or a batch's lanes, every scalar and the small ring
metadata are replicated, and every reduction over d is a float64 local
partial finished by one all-reduce over the group, for all lanes at once
(``fused_ops._rdot``, ``reduce_parts``).  The objective callables are then
shard-local ones that finish their own sums (``dist.sharded``).  All
control flow reads replicated scalars, so the ranks take the same
branches.  Without a comm none of this runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..kernels.fused_ops import _dot, _rdot, _vdot, iteration_tail
from ..linesearch.strategies import get_line_search, reads_on_host
from ..types import Guard, LBFGSState, SolveResult, Status, Trace, per_lane
from ..utils.accurate import compensated_dot
from . import blocks
from .direction import _gamma, compute_direction_with_aux, history_products

ObjFn = Callable[[Tensor], Tensor]
ValGradFn = Callable[[Tensor], Tuple[Tensor, Tensor]]


def resolve_history_dtype(history_dtype, m: int, d: int, dtype,
                          batch: int = 1):
    """Resolve ``history_dtype="auto"``, with the reference's signature;
    any other value is returned as it is.

    "auto" is None here, the iterate's dtype, at every m, d and batch.  The
    reference's rule (bfloat16 once the ring no longer stays in the TPU's
    VMEM and tiles cleanly) is a rule of that memory and does not carry
    over, and on an NVIDIA H100 80GB HBM3 (700 W) a bfloat16 ring bought no
    time at m = 10 (chip_smoke.py, ``[kernel]`` and ``[cli]`` lines): at
    d = 2^20 the fused tail with its history products took 93 us on a
    bfloat16 ring against 14 + 47 us for the tail and the solver's two
    products on a float32 one, at d = 2^24 1190 against 210 + 494 us (the
    kernel waits on float-to-double conversions, not on bytes), and the
    solves ran 3.4-5.4 against 3.0-5.4 ms per iteration, bound by the
    host.  bfloat16 halves the ring's memory; ask for it by name."""
    del m, d, dtype, batch
    if history_dtype != "auto":
        return history_dtype
    return None


@torch.no_grad()
def init_state(vg: ValGradFn, x0: Tensor, m: int,
               history_dtype=None, comm=None) -> LBFGSState:
    """The initial state; evaluates f and the gradient once at x0, which is
    (d,) or, for a batch of instances, (B, d).  ``history_dtype`` stores
    the (m, d) ring in another dtype than x0's ("bfloat16", "float32"; the
    scalars and the small matrices keep x0's); None keeps x0's and "auto"
    goes through ``resolve_history_dtype``.  With ``comm``, x0 is this
    shard's block and ``vg`` a shard-local objective (module docstring)."""
    dtype, dev = x0.dtype, x0.device
    history_dtype = resolve_history_dtype(history_dtype, m, x0.shape[-1],
                                          dtype)
    hdtype = getattr(torch, history_dtype) if history_dtype else dtype
    if x0.dim() not in (1, 2):
        raise ValueError(f"x0 must be (d,) or (B, d), got {tuple(x0.shape)}")
    lead, d = tuple(x0.shape[:-1]), x0.shape[-1]
    f0, g0 = vg(x0)

    # torch.full fills on the device; torch.tensor(v, device=...) would copy
    # from the host and wait for the copy.
    def full(shape, v, dt=dtype):
        return torch.full(lead + shape, v, dtype=dt, device=dev)

    i32 = torch.int32
    state = LBFGSState(
        x=x0,
        f=f0,
        g=g0,
        g_norm=torch.sqrt(_rdot(comm, g0, g0)),
        s_hist=full((m, d), 0.0, hdtype),
        y_hist=full((m, d), 0.0, hdtype),
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
    if _DEBUG_NANS:
        check_finite(state, comm)
    return state


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
             d: Tensor, dir_poly=None, phi_batch=None, phi_dphi_batch=None,
             comm=None):
    """phi / phi_dphi of the line search.

    The lane axis is x's: a step of x's lane shape, () for one instance or
    (B,) for a batch, is one trial per lane; with one more trailing axis,
    (K,) or (B, K), it is K trials per lane, and phi returns that shape.

    ``ls_eval="polynomial"``: from the closed-form directional polynomial,
    one pass over (x, d) for the coefficients, then every trial is scalar
    Horner work on its lane's row of coefficients.

    ``ls_eval="direct"``: a trial is f(x + a d), a Wolfe trial vg(x + a d)
    and g_new . d, each a full pass, over every lane at once.  K trials per
    lane, which the speculative searches ask for, go through ``phi_batch``
    / ``phi_dphi_batch`` when given (one pass for all K: x, d and the
    alphas of x's lane shape plus K; ``problems.suite.multi_phi_for`` /
    ``multi_phi_dphi_for`` for one instance, ``dist.pallas_sharded``'s for
    a shard's lanes), else trial by trial, as the reference's vmap does."""
    lanes = x.dim() - 1
    if cfg.ls_eval == "polynomial":
        if dir_poly is None:
            raise ValueError("ls_eval='polynomial' requires dir_poly "
                             "(see Problem.dir_poly)")
        coeffs = dir_poly(x, d)
        # K trials per lane see their lane's row across the trial axis.
        coeffs_k = coeffs.unsqueeze(-2) if lanes else coeffs

        def rows(a):
            return coeffs_k if a.dim() > lanes else coeffs

        def phi(a):
            return _polyval(rows(a), a)

        def phi_dphi(a):
            c = rows(a)
            return _polyval(c, a), _polyval(_polyder(c), a)

        return phi, phi_dphi

    def one_dphi(a):
        f_new, g_new = vg(x + per_lane(a) * d)
        return f_new, _rdot(comm, g_new, d)

    def phi(a):
        if a.dim() == lanes:
            return f(x + per_lane(a) * d)
        if phi_batch is not None:
            return phi_batch(x, d, a)
        return torch.stack([f(x + per_lane(aa) * d) for aa in a.unbind(-1)],
                           dim=-1)

    def phi_dphi(a):
        if a.dim() == lanes:
            return one_dphi(a)
        if phi_dphi_batch is not None:
            return phi_dphi_batch(x, d, a)
        fs, dphis = zip(*(one_dphi(aa) for aa in a.unbind(-1)))
        return torch.stack(fs, dim=-1), torch.stack(dphis, dim=-1)

    return phi, phi_dphi


def _sharded_tail(x, d, alpha, g, g_new, accurate: bool, damped: bool,
                  comm):
    """``iteration_tail_plain`` and the two sums beside it for one shard:
    (x_new, s, y, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new, s.s or
    None), the sums as float64 partials (compensated locally under
    ``accurate``) finished by one packed all-reduce, each lane's for a
    batch."""
    s = per_lane(alpha) * d
    y = g_new - g
    a, b = [s, y, g_new, d, g, y], [y, y, g_new, g_new, g_new, g_new]
    if damped:
        a, b = a + [s], b + [s]
    a, b = torch.stack(a).double(), torch.stack(b).double()
    parts = compensated_dot(a, b) if accurate else torch.sum(a * b, dim=-1)
    (sums,) = comm.reduce_parts([parts], x.dtype)
    sy, yy, gg_new, dgn, ggn, ygn = sums[:6].unbind(0)
    return (x + s, s, y, sy, yy, gg_new, dgn, ggn, ygn,
            sums[6] if damped else None)


def _matvec(rows: Tensor, v: Tensor, dtype) -> Tensor:
    """rows (m, d) times v (d,), or per lane (B, m, d) times (B, d), in
    ``dtype``: operands in another dtype (a bfloat16 ring and row) are
    widened first, so their products are exact and add up in ``dtype``, as
    the reference's ``preferred_element_type`` has them."""
    if rows.dtype != dtype:
        rows = rows.to(dtype)
    if v.dtype != dtype:
        v = v.to(dtype)
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


@torch.no_grad()
def iterate(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn, state: LBFGSState,
            dir_poly=None, fused_tail=None, phi_batch=None,
            phi_dphi_batch=None, lanes=None, comm=None,
            bounded: bool = False) -> LBFGSState:
    """One unconditional L-BFGS iteration (assumes status == RUNNING).
    ``fused_tail``: the post-line-search tail
    (problems.suite.fused_tail_for), which replaces the x_new, ``vg`` and
    ``iteration_tail`` chain with one kernel; under ``cfg.accurate_dots`` it
    must carry ``accurate_dots = True`` (a plain tail would drop the
    compensation that was asked for, so it is rejected).  Without one,
    ``kernels.fused_ops.iteration_tail`` runs after ``vg``: the CUDA kernel
    under ``cfg.use_pallas`` on the card.  ``phi_batch`` /
    ``phi_dphi_batch``: the K-trial evaluators of the speculative searches
    under ``ls_eval="direct"`` (``make_phi``).  Updates the history ring in
    place (module docstring).

    ``lanes``: an optional bool mask, (B,) for a batched state.  A lane
    where it is False keeps every field, its ring rows included: the freeze
    that the reference's vmapped ``while_loop`` applies to a lane whose
    loop condition has failed.

    ``comm``: the state is one shard of a sharded solve and every
    reduction over d crosses the group (module docstring).

    ``bounded``: the line search runs its fixed-trip loop (its own trip
    bound, finished lanes frozen) and reads nothing on the host, instead of
    reading its loop condition once per turn (``linesearch.strategies``);
    both give the same iterate bit for bit."""
    if cfg.accurate_dots and fused_tail is not None \
            and not getattr(fused_tail, "accurate_dots", False):
        raise ValueError(
            "cfg.accurate_dots requires a fused tail built with "
            "accurate_dots=True (fused_tail_for(..., accurate_dots=True))")
    m, dim = state.s_hist.shape[-2:]
    x, g = state.x, state.g
    dtype, hdtype = x.dtype, state.s_hist.dtype
    incremental = cfg.direction == "compact_incremental"

    # --- search direction with descent safeguard (lbfgs.cpp:147-153) --------
    # The compact paths give phi'(0) = g.d from the direction's coefficients
    # in O(m); the two-loop takes a full dot.
    d, aux, dir_fallback = compute_direction_with_aux(cfg, state, comm)
    g_dot_d = _rdot(comm, g, d) if aux is None else aux.g_dot_d
    not_descent = g_dot_d >= 0
    d = torch.where(per_lane(not_descent), -g, d)
    g_dot_d = torch.where(not_descent, -state.g_norm * state.g_norm, g_dot_d)

    # --- line search -------------------------------------------------------
    phi, phi_dphi = make_phi(cfg, f, vg, x, d, dir_poly, phi_batch,
                             phi_dphi_batch, comm)
    ls = get_line_search(cfg.line_search)(cfg, phi, phi_dphi, state.f,
                                          g_dot_d, bounded=bounded)
    alpha = ls.alpha

    # --- trial point, f/g there, pair and scalars ---------------------------
    step_failed = alpha < cfg.step_fail_tol
    damped = cfg.damping is not None
    if fused_tail is not None:
        # One pass: the kernel forms y = g_new - g itself and hands out both
        # rows in the history's dtype, so damping blends those below.  With
        # the tail's matvec, t1 / t2 are S y / Y y against the raw y, over
        # the rows before the write.  s.s = alpha^2 d.d costs one more pass
        # over d.
        (x_new, f_new, g_new, s_h, y_raw, sy, yy, gg_new, dgn, _ggn, ygn,
         t1, t2) = fused_tail(x, d, alpha, g, state.s_hist, state.y_hist)
        ss = alpha * alpha * _rdot(comm, d, d) if damped else None
    elif comm is not None:
        t1 = t2 = None
        f_new, g_new = vg(x + per_lane(alpha) * d)
        (x_new, s_h, y_raw, sy, yy, gg_new, dgn, _ggn, ygn,
         ss) = _sharded_tail(x, d, alpha, g, g_new, cfg.accurate_dots,
                             damped, comm)
    else:
        t1 = t2 = None
        x_new = x + per_lane(alpha) * d
        f_new, g_new = vg(x_new)
        # Under accurate_dots the kernel compensates its cross-block
        # accumulation itself and the two sums beside it stay plain; without
        # the kernel every sum goes through compensated_dot.
        x_new, s_h, y_raw, sy, yy, gg_new, dgn, _ggn = iteration_tail(
            x, d, alpha, g, g_new, use_pallas=cfg.use_pallas,
            accurate=cfg.accurate_dots)
        dot = compensated_dot if cfg.accurate_dots and not cfg.use_pallas \
            else _dot
        ygn = dot(y_raw, g_new)
        ss = dot(s_h, s_h) if damped else None
    y_h = y_raw
    narrow = hdtype != dtype

    damp_fired = None
    if damped:
        # Powell damping with B0 = I / gamma: y_bar = theta y + (1 - theta)
        # s / gamma when s.y < mu s.s / gamma.  It runs after either tail,
        # and the blended scalars follow from the raw sums:
        #   s.y_bar     = theta sy + (1 - theta) ss / gamma
        #   y_bar.y_bar = theta^2 yy + 2 theta (1 - theta) sy / gamma
        #                 + ((1 - theta) / gamma)^2 ss
        #   y_bar.g_new = theta ygn + (1 - theta) (s.g_new) / gamma,
        #   s.g_new = alpha dgn.
        # The raw y stays for the incremental Sg / Yg advance below, whose
        # invariant is over the raw gradient difference g_new = g + y_raw.
        gamma_p = _gamma(state, m)         # 1.0 before the first pair
        sBs = ss / gamma_p
        # mu in the working dtype, as the reference's array, so that 1 - mu
        # rounds there (from a double it may land an ulp away in float32);
        # a fill on the device, not a copy from the host.
        mu = torch.full((), cfg.damping, dtype=sy.dtype, device=sy.device)
        damp_fired = sy < mu * sBs
        denom = sBs - sy
        theta = torch.where(
            damp_fired & (denom > 0) & torch.isfinite(denom),
            (1.0 - mu) * sBs / torch.where(denom > 0, denom, 1.0), 1.0)
        one_m = (1.0 - theta) / gamma_p
        # Without a fused tail the raw s and y are blended and the result
        # is cast once below; the fused tail's rows are already in the
        # history's dtype and are widened for the blend.
        if narrow and fused_tail is not None:
            y_h = per_lane(theta) * y_raw.to(dtype) \
                + per_lane(one_m) * s_h.to(dtype)
        else:
            y_h = per_lane(theta) * y_raw + per_lane(one_m) * s_h
        ygn = theta * ygn + one_m * (alpha * dgn)
        yy = theta * theta * yy + 2.0 * theta * one_m * sy \
            + one_m * one_m * ss
        sy = theta * sy + one_m * ss
        damp_fired = damp_fired & (theta < 1.0)

    failed = (step_failed | ~torch.isfinite(f_new) | ~torch.isfinite(gg_new)
              | (state.status != Status.RUNNING))
    store = ~failed & (sy > cfg.curvature_threshold)
    if lanes is not None:
        store = store & lanes

    if narrow:
        # The rows as the ring stores them.  The products below contract the
        # ring against y in the history's dtype, as the reference does.
        s_h, y_raw, y_h = s_h.to(hdtype), y_raw.to(hdtype), y_h.to(hdtype)

    if incremental:
        # u1 = S y_raw, u2 = Y y_raw over the rows before the write below:
        # the one fresh contraction per iteration, against the RAW y (the
        # damped row would corrupt every off-slot Sg / Yg entry); from the
        # fused tail where it computed them.
        # Sharded, the products are float64 partials over this shard's
        # columns, finished together by one all-reduce.
        mv_dtype = dtype if comm is None else torch.float64
        prods = []
        if t1 is None:
            prods += [_matvec(state.s_hist, y_raw, mv_dtype),
                      _matvec(state.y_hist, y_raw, mv_dtype)]
        if damped:
            prods += [_matvec(state.s_hist, s_h, mv_dtype),
                      _matvec(state.y_hist, s_h, mv_dtype)]
        if comm is not None and prods:
            prods = comm.reduce_parts(prods, dtype)
        u1, u2 = (t1, t2) if t1 is not None else prods[:2]
        if damped:
            us1, us2 = prods[-2:]

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

    # --- incremental history products (direction="compact_incremental");
    # the other directions carry them unchanged ----------------------------
    SY_next, YY_next = state.SY, state.YY
    Sg_next, Yg_next = state.Sg, state.Yg
    failed_vec = per_lane(failed)
    if incremental:
        # s_i.g_new = s_i.g + s_i.y_raw; the slot's entries come from the
        # tail's exact sums (Yg[slot] is the stored row's dot, the damped
        # y_bar.g_new when damping fired).
        Sg_next = torch.where(sel, per_lane(alpha * dgn), state.Sg + u1)
        Yg_next = torch.where(sel, per_lane(ygn), state.Yg + u2)
        # The new column of SY / YY is over the STORED y row: u1 / u2, or
        # under damping their blend with S s_new / Y s_new.
        if damped:
            theta_l, one_m_l = per_lane(theta), per_lane(one_m)
            col1 = theta_l * u1 + one_m_l * us1
            col2 = theta_l * u2 + one_m_l * us2
        else:
            col1, col2 = u1, u2
        sy_col = torch.where(is_slot, sy_l, col1)
        yy_col = torch.where(is_slot, yy_l, col2)
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
        damp_fired & ~failed if damped else torch.zeros_like(failed),
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


def _any(cond: Tensor) -> bool:
    """Whether the condition holds (on any lane): one host read."""
    return bool(cond.any() if cond.dim() else cond)


def _refresh_interval(cfg: LBFGSConfig) -> Optional[int]:
    """cfg.refresh_interval where it applies (compact_incremental)."""
    if cfg.direction == "compact_incremental":
        return cfg.refresh_interval
    return None


@torch.no_grad()
def refresh_products(state: LBFGSState, comm=None) -> LBFGSState:
    """Recompute the incremental products SY / YY / Sg / Yg from the stored
    rows and the current gradient (the ``compact`` path's contractions),
    which zeroes the rounding drift that ``compact_incremental`` adds up in
    the off-diagonal entries.  The diagonals come from the per-slot exact
    tail sums (sy_hist / yy_hist).  Called between solve segments
    (``cfg.refresh_interval``), never inside an iteration."""
    SY, YY, Sg, Yg = history_products(state, comm)
    eye = torch.eye(SY.shape[-1], dtype=torch.bool, device=SY.device)
    SY = torch.where(eye, state.sy_hist[..., None, :], SY)
    YY = torch.where(eye, state.yy_hist[..., None, :], YY)
    return state.replace(SY=SY, YY=YY, Sg=Sg, Yg=Yg)


#: Whether every solve checks its state and its objective's outputs for
#: non-finite values (``set_debug_nans``).
_DEBUG_NANS = False


def set_debug_nans(enabled: bool) -> None:
    """``--debug-nans``, the counterpart of the reference's
    ``jax_debug_nans`` (``tpu_lbfgs/cli.py:127-128``), which raises where
    an operation makes a NaN.  While enabled, every solve checks its state
    as ``init_state`` makes it and after every iteration, and raises
    ``FloatingPointError`` at the first non-finite field
    (``check_finite``); and it checks every output of the objective's
    callables (f, the value and gradient, the directional polynomial, the
    fused tail, the K-trial evaluators) for NaN as they return, since the
    solver's guards keep a NaN trial or gradient out of the state (a failed
    step keeps the last one).  That costs a host read per iteration and per
    evaluation (in a sharded solve an all-reduce of the flags, so that
    every rank raises); disabled, nothing is read."""
    global _DEBUG_NANS
    _DEBUG_NANS = bool(enabled)


def _nan_checked(fn, name: str, comm=None):
    """``fn`` raising ``FloatingPointError`` when an output holds a NaN."""
    def checked(*args, **kwargs):
        out = fn(*args, **kwargs)
        flat = [t for t in (out if isinstance(out, (tuple, list)) else (out,))
                if isinstance(t, Tensor)]
        bad = torch.stack([torch.isnan(t).any() for t in flat]).any()
        if comm is not None:
            bad = comm.any_flag(bad)
        if bool(bad):
            raise FloatingPointError(f"debug-nans: NaN in the output of {name}")
        return out

    return checked


def check_finite(state: LBFGSState, comm=None) -> None:
    """Raise ``FloatingPointError`` naming the first floating field of
    ``state`` (in ``LBFGSState``'s order) that holds a NaN or an infinity
    on any lane or, with ``comm``, on any rank of the group."""
    names = [fl.name for fl in dataclasses.fields(LBFGSState)
             if getattr(state, fl.name).is_floating_point()]
    bad = torch.stack([~torch.isfinite(getattr(state, name)).all()
                       for name in names])
    if comm is not None:
        bad = comm.any_flag(bad)
    bad = bad.tolist()
    if any(bad):
        raise FloatingPointError(
            f"debug-nans: non-finite {names[bad.index(True)]} in the solver "
            f"state at iteration {int(state.k.max())}")


def _stepper(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn, *callables,
             comm=None, bounded: bool = False):
    """``step(state, lanes=None)``: one ``iterate`` of this solve, its line
    search on the fixed-trip loop under ``bounded``; under
    ``set_debug_nans(True)`` the callables' outputs are checked as they
    return and the state after each step (``check_finite``)."""
    if _DEBUG_NANS:
        names = ("dir_poly", "fused_tail", "phi_batch", "phi_dphi_batch")
        f, vg = _nan_checked(f, "f", comm), _nan_checked(vg, "vg", comm)
        callables = [c if c is None else _nan_checked(c, name, comm)
                     for c, name in zip(callables, names)]

    def step(state, lanes=None):
        return iterate(cfg, f, vg, state, *callables, lanes=lanes, comm=comm,
                       bounded=bounded)

    if not _DEBUG_NANS:
        return step

    def checked(state, lanes=None):
        state = step(state, lanes)
        check_finite(state, comm)
        return state

    return checked


def _blocked(cfg: LBFGSConfig, state: LBFGSState, comm, bounded: bool,
             budget: int) -> bool:
    """Whether a solve of at most ``budget`` iterations runs in blocks
    (``core.blocks``; CUDA graphs on the card).  It keeps the
    per-iteration loop, by its arguments, for a sharded solve (``comm``),
    under ``set_debug_nans(True)`` and, outside ``bounded``, for a line
    search that reads its loop condition on the host
    (``strategies.reads_on_host``) unless its blocks are captured
    (``blocks.captures``), where the search runs on the gated driver and
    reads nothing: eager blocks of such a search would read as often as
    that loop and cost more."""
    if comm is not None or _DEBUG_NANS:
        return False
    if bounded or not reads_on_host(cfg, state.x.dim() == 2):
        return True
    return blocks.captures(state.x.device, budget, gated=True)


def _callables(f, vg, dir_poly, fused_tail, phi_batch,
               phi_dphi_batch) -> dict:
    """The solve's callables by name, for a block runner."""
    return {"f": f, "vg": vg, "dir_poly": dir_poly, "fused_tail": fused_tail,
            "phi_batch": phi_batch, "phi_dphi_batch": phi_dphi_batch}


def _run_segment(cfg: LBFGSConfig, step, state: LBFGSState,
                 iters: Optional[int], emit=None) -> LBFGSState:
    """Iterate while running, for at most ``iters`` more iterations of each
    lane when given (counted on the device from each lane's k); one host
    read per iteration.  ``emit(state)`` is called after every iteration.
    The per-iteration loop of the solves that ``_blocked`` leaves out."""
    k_cap = None if iters is None else torch.clamp(state.k + iters,
                                                   max=cfg.max_iters)
    while True:
        running = _running(cfg, state)
        if k_cap is not None:
            running = running & (state.k < k_cap)
        if not _any(running):
            return state
        state = step(state, lanes=running if running.dim() else None)
        if emit is not None:
            emit(state)


def solve_from_state(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                     state: LBFGSState, dir_poly=None, fused_tail=None,
                     phi_batch=None, phi_dphi_batch=None,
                     comm=None, kept=None) -> LBFGSState:
    """Iterate while running; returns the final state with its status
    finalized.  A lane stops the moment its own condition fails and keeps
    its state from then on, as under the reference's vmapped
    ``while_loop``.  In blocks of iterations (``core.blocks``: CUDA graphs
    on the card) the host reads the loop's flags once per block, 1 +
    ceil(n / BLOCK_ITERS) times for n iterations; where ``_blocked`` says
    no, once per iteration (for a batch: whether any lane still runs).

    With ``cfg.refresh_interval`` set (compact_incremental only) the run is
    split into segments of up to that many iterations, counted from the k
    each segment starts at, and the history products are recomputed after
    every segment (``refresh_products``), for the lanes that entered it.

    ``kept``: a ``blocks.Kept`` that keeps the block runner, and its graphs,
    for the next solve of the same configuration; the solve then returns
    the kept buffers, which that next solve overwrites."""
    if cfg.record_trace:
        return _solve_traced(cfg, f, vg, state, dir_poly, fused_tail,
                             phi_batch, phi_dphi_batch, comm)[0]
    step = _stepper(cfg, f, vg, dir_poly, fused_tail, phi_batch,
                    phi_dphi_batch, comm=comm)
    interval = _refresh_interval(cfg)
    if _blocked(cfg, state, comm, False, cfg.max_iters):
        drv = blocks.runner("while", cfg, step, state, interval, _callables(
            f, vg, dir_poly, fused_tail, phi_batch, phi_dphi_batch),
            cfg.max_iters, kept=kept)
        state = blocks.solve_while(drv, interval)
    elif interval is None:
        state = _run_segment(cfg, step, state, None)
    else:
        while True:
            entered = _running(cfg, state)
            if not _any(entered):
                break
            out = refresh_products(_run_segment(cfg, step, state, interval),
                                   comm)
            state = _keep_lanes(entered, out, state) if entered.dim() else out
    return state.replace(status=_finalize_status(cfg, state))


def solve_bounded(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                  state: LBFGSState, dir_poly=None, fused_tail=None,
                  phi_batch=None, phi_dphi_batch=None,
                  comm=None, kept=None) -> LBFGSState:
    """Exactly ``cfg.max_iters`` more iterations with no read of the loop
    condition: safe because iterate is idempotent on finished states
    (lanes).  The line search runs its fixed-trip loop, or inside a
    captured block the gated driver, which runs only the live turns, so no
    search reads on the host either, in direct mode included; the
    iterations run in blocks (``core.blocks``: CUDA graphs on the card)
    unless the solve is sharded or ``set_debug_nans(True)`` holds.  A
    state that would
    have converged early keeps iterating to the budget.  The budget and,
    with ``cfg.refresh_interval``
    (compact_incremental), the refresh points are relative to the state
    given: a refresh after every full ``refresh_interval`` iterations, none
    after the remainder.  ``kept`` as under ``solve_from_state``."""
    interval = _refresh_interval(cfg)
    if interval is not None and interval >= cfg.max_iters:
        interval = None
    step = _stepper(cfg, f, vg, dir_poly, fused_tail, phi_batch,
                    phi_dphi_batch, comm=comm, bounded=True)
    if _blocked(cfg, state, comm, True, cfg.max_iters):
        drv = blocks.runner("bounded", cfg, step, state, interval, _callables(
            f, vg, dir_poly, fused_tail, phi_batch, phi_dphi_batch),
            cfg.max_iters, kept)
        state = blocks.solve_fixed(drv, cfg.max_iters, interval)
    else:
        for i in range(1, cfg.max_iters + 1):
            state = step(state)
            if interval and i % interval == 0:
                state = refresh_products(state, comm)
    return state.replace(status=_finalize_status(cfg, state))


def make_solve_segment(cfg: LBFGSConfig, f: ObjFn, grad=None,
                       value_and_grad=None, iters: Optional[int] = None,
                       dir_poly=None, fused_tail=None, phi_batch=None,
                       phi_dphi_batch=None, donate: bool = True):
    """A ``state -> state`` function that runs up to ``iters`` iterations
    (default ``cfg.refresh_interval``, else ``cfg.max_iters``) or to
    convergence, for solves driven in segments from the host: periodic
    checkpoints, monitoring, very long runs.

    Segments do not finalize the status (one that ends at its cap is still
    RUNNING); call ``finalize_result`` after the last.  With
    ``cfg.refresh_interval`` set (compact_incremental) the history products
    are refreshed at the end of every segment.

    The port's ring is updated in place, so the state passed in must not
    be used again, whatever ``donate`` says.  The segment runs in blocks
    (``core.blocks``) where ``_blocked`` says so, and the function keeps
    its block runner, graphs and buffers across calls (``blocks.Kept``): a
    state is copied into the buffers (none is copied when it is the state
    the last call returned).  ``donate``, the reference's buffer donation:
    True returns the buffers, which the next call overwrites, as a donated
    state is; False returns a copy of every field, so that no later call
    changes a state returned earlier, as the reference's fresh outputs."""
    vg = make_value_and_grad(f, grad, value_and_grad)
    seg_iters = iters if iters is not None \
        else (cfg.refresh_interval if cfg.refresh_interval is not None
              else cfg.max_iters)
    step = _stepper(cfg, f, vg, dir_poly, fused_tail, phi_batch,
                    phi_dphi_batch)
    refresh = _refresh_interval(cfg) is not None
    kept = blocks.Kept()

    def segment(state: LBFGSState) -> LBFGSState:
        budget = min(seg_iters, cfg.max_iters)
        if _blocked(cfg, state, None, False, budget):
            drv = blocks.runner("segment", cfg, step, state, None, _callables(
                f, vg, dir_poly, fused_tail, phi_batch, phi_dphi_batch),
                budget, kept=kept)
            out = blocks.solve_segment(drv, seg_iters, refresh)
            return out if donate else out.replace(**{
                n.name: getattr(out, n.name).clone()
                for n in dataclasses.fields(out)})
        out = _run_segment(cfg, step, state, seg_iters)
        if refresh:
            out = refresh_products(out)
        return out

    return segment


def finalize_result(cfg: LBFGSConfig, state: LBFGSState) -> SolveResult:
    """Resolve a RUNNING status to CONVERGED / MAX_ITERS and package a
    SolveResult: the closing step of a ``make_solve_segment`` loop."""
    return _state_to_result(
        state.replace(status=_finalize_status(cfg, state)))


def _solve_traced(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                  state: LBFGSState, dir_poly=None, fused_tail=None,
                  phi_batch=None, phi_dphi_batch=None, comm=None
                  ) -> Tuple[LBFGSState, Trace]:
    """The solve with per-iteration metrics: f, g_norm, alpha, n_fev, n_gev
    and the guard counters after each of ``cfg.max_iters`` iterations, kept
    on the device.  Once no lane runs the state is frozen, so the remaining
    rows are copies of the last one and are filled in without iterating.

    ``cfg.refresh_interval`` (compact_incremental) is honoured at the
    reference's points: after every ``refresh_interval`` iterations counted
    from the state given, and after the last, partial segment.  In blocks
    where ``_blocked`` says so (``blocks.solve_traced``: each iteration
    writes its row into a (max_iters, ...) buffer on the device, one read
    per block), else one read per iteration, the loop condition, and the
    rows stacked at the end."""
    step = _stepper(cfg, f, vg, dir_poly, fused_tail, phi_batch,
                    phi_dphi_batch, comm=comm)
    interval = _refresh_interval(cfg)
    if interval is not None and interval >= cfg.max_iters:
        interval = None
    if _blocked(cfg, state, comm, False, cfg.max_iters):
        drv = blocks.runner("traced", cfg, step, state, interval, _callables(
            f, vg, dir_poly, fused_tail, phi_batch, phi_dphi_batch),
            cfg.max_iters)
        state = blocks.solve_traced(drv, interval)
        return (state.replace(status=_finalize_status(cfg, state)),
                drv.trace())
    fields = Trace._fields
    rows = []

    def emit(s):
        rows.append(tuple(getattr(s, name) for name in fields))

    while len(rows) < cfg.max_iters:
        before = len(rows)
        want = min(interval or cfg.max_iters, cfg.max_iters - before)
        state = _run_segment(cfg, step, state, want, emit)
        if interval is not None:
            state = refresh_products(state, comm)
        if len(rows) - before < want:
            break       # stopped early: every later row is a frozen copy
    if not rows:
        emit(state)
        rows = rows * cfg.max_iters
    rows += [rows[-1]] * (cfg.max_iters - len(rows))
    # One row per iteration after each lane's own axis: (max_iters, ...) or,
    # for a batch, (B, max_iters, ...), as the reference's vmapped scan.
    axis = state.x.dim() - 1
    trace = Trace(*(torch.stack(col, dim=axis) for col in zip(*rows)))
    return state.replace(status=_finalize_status(cfg, state)), trace


def _state_to_result(state: LBFGSState,
                     trace: Optional[Trace] = None) -> SolveResult:
    return SolveResult(
        x=state.x, f=state.f, g_norm=state.g_norm, iterations=state.k,
        status=state.status, n_fev=state.n_fev, n_gev=state.n_gev,
        trace=trace, guards=state.guards)


def solve_to_result(cfg: LBFGSConfig, f: ObjFn, vg: ValGradFn,
                    state: LBFGSState, dir_poly=None, fused_tail=None,
                    phi_batch=None, phi_dphi_batch=None,
                    bounded: bool = False, comm=None) -> SolveResult:
    """Solve from ``state`` and package the result, with its trace under
    ``cfg.record_trace``: what ``minimize`` and ``vmap_minimize`` run."""
    args = (cfg, f, vg, state, dir_poly, fused_tail, phi_batch,
            phi_dphi_batch, comm)
    if bounded:
        return _state_to_result(solve_bounded(*args))
    if cfg.record_trace:
        return _state_to_result(*_solve_traced(*args))
    return _state_to_result(solve_from_state(*args))


def make_value_and_grad(f: ObjFn, grad=None, value_and_grad=None) -> ValGradFn:
    """The objective interface: ``value_and_grad`` if given, else f with
    its analytic ``grad``, else f with its exact gradient from autograd
    (where the reference takes ``jax.value_and_grad``).  For a batch, f
    returns one value per lane and each lane's gradient is its own row."""
    if value_and_grad is not None:
        return value_and_grad
    if grad is not None:
        return lambda x: (f(x), grad(x))

    def autograd_vg(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            fx = f(xr)
            (g,) = torch.autograd.grad(fx.sum(), xr)
        return fx.detach(), g

    return autograd_vg


def minimize(f: ObjFn, x0: Tensor, cfg: LBFGSConfig = LBFGSConfig(),
             grad=None, value_and_grad=None, dir_poly=None,
             fused_tail=None, phi_batch=None,
             phi_dphi_batch=None) -> SolveResult:
    """Solve from x0 on x0's device.  The entry point of the reference's
    ``tpu_lbfgs.minimize``, without its JAX-only arguments.  With f alone,
    autograd supplies the gradient."""
    vg = make_value_and_grad(f, grad, value_and_grad)
    state = init_state(vg, x0, cfg.m, cfg.history_dtype)
    return solve_to_result(cfg, f, vg, state, dir_poly, fused_tail,
                           phi_batch, phi_dphi_batch)
