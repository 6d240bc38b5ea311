"""The line searches of ``tpu_lbfgs.linesearch.strategies``: the paper's
four Table-I searches, the parallel implementation's bisection, and the
three speculative twins.

They see the objective only through phi(alpha) = f(x + alpha d) and
phi_dphi(alpha) = (phi, phi'), built by ``core.solver.make_phi``.  Every
scalar of a search carries the lane shape of ``f_x``: () for one instance,
(B,) for a batch, in the working dtype on the device, so each operation
rounds as the reference's weak-typed scalar arithmetic does.  K trials are
(..., K); ``phi`` of a step of the lane shape is one trial per lane.

The reference runs each search as a ``lax.while_loop`` on the device, and a
batch as its ``jax.vmap``: the loop runs while any lane's condition holds,
and a lane whose condition has failed keeps its carry.  Here each search
is one turn, ``cond`` / ``body`` over the lanes, and one of two loops
runs it (``_loop``):

- read-driven (the default): while any lane's condition holds, one bool
  read on the host per turn, that is one per trial for the sequential
  searches and one per K-wide round for the speculative twins
  (``host_reads`` counts them).  ``solve_from_state`` and
  ``vmap_minimize(lockstep="while")`` use it.
- fixed-trip (``bounded=True``): exactly the search's own trip bound
  (``cfg.ls_max_iters``, ``cfg.ls_safety_cap``, or the ladder's length),
  with finished lanes frozen by a ``torch.where``; it reads nothing.
  ``solve_bounded`` and ``vmap_minimize(lockstep="bounded")`` use it.

A finished lane is frozen in both, so the two give the same result bit for
bit.  Each body is the reference's body, line for line.

``backtracking`` under ``ls_eval="polynomial"`` (the bench.py path) takes
no loop at all: a trial is one scalar Horner evaluation, so the port tests
the whole ladder alpha_k = initial_step * shrink^k at once (27 trials at
the defaults) and reads nothing.  The ladder is built by the loop's own
repeated multiplication in the working dtype, and each trial runs the
loop's own comparison, so the accepted alpha is bit-identical to the
loop's; each lane picks its own first accepted trial.

Fidelity traps 1-5 of the reference (``tpu_lbfgs.linesearch.strategies``
docstring) are reproduced under ``cfg.fidelity == "reference"``, not fixed.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Callable

import numpy as np
import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..types import LineSearchResult, per_lane
from .interpolate import (
    cubic_interpolate,
    cubic_interpolate_fixed,
    quadratic_interpolate,
    quadratic_interpolate_fixed,
    safe_cubic_interpolate,
)

_LADDER_CAP = 100_000

#: Loop conditions read on the host since the last ``reset_host_reads()``.
host_reads = {"line_search": 0}


def reset_host_reads() -> None:
    host_reads["line_search"] = 0


def _read(*flags: Tensor) -> list[bool]:
    """Whether each loop condition holds on any lane, in one transfer."""
    host_reads["line_search"] += 1
    flags = [f.any() if f.dim() else f for f in flags]
    return (torch.stack(flags) if len(flags) > 1
            else flags[0].reshape(1)).tolist()


def reads_on_host(cfg: LBFGSConfig, batched: bool) -> bool:
    """Whether ``cfg``'s search, driven read-driven, reads on the host:
    every search but ``backtracking`` on the directional polynomial or on
    a batch (the whole ladder at once, no loop)."""
    return not (cfg.line_search == "backtracking"
                and (cfg.ls_eval == "polynomial" or batched))


def _refuse_capture(what: str) -> None:
    """Raise inside a CUDA graph capture: ``what`` is a host-to-device copy,
    made once per configuration and device and cached, which a capture
    cannot take.  The warm-up before a capture makes it (``core.blocks``),
    so this is a table that the warm-up missed."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{what} is copied from the host during a CUDA graph capture: "
            "its cached table was not made before the capture")


def _select(go: Tensor, new: tuple, old: tuple) -> tuple:
    """The carry ``new`` on the lanes where ``go`` holds, ``old`` elsewhere."""
    return tuple(torch.where(go, a, b) for a, b in zip(new, old))


def _loop(cond, body, carry, trips: int, bounded: bool, enter=None):
    """Run one search's turn until its condition fails on every lane.

    Read-driven (``bounded=False``): ``lax.while_loop`` driven from the
    host, one bool read per turn; on a batch a lane whose condition has
    failed keeps its carry.  ``enter`` is the first condition where the
    caller knows it from the configuration alone; it is then not read.
    Fixed-trip (``bounded=True``): ``trips`` turns, the search's own bound,
    each lane frozen once its condition fails; no read."""
    if bounded:
        for _ in range(trips):
            carry = _select(cond(carry), body(carry), carry)
        return carry
    lanes = carry[0].dim() > 0
    go = cond(carry) if lanes or enter is None else None
    more = _read(go)[0] if enter is None else enter
    while more:
        new = body(carry)
        carry = _select(go, new, carry) if lanes else new
        go = cond(carry)
        more = _read(go)[0]
    return carry


def _full(v, like: Tensor, dtype=None) -> Tensor:
    return torch.full(like.shape, v, dtype=dtype or like.dtype,
                      device=like.device)


def _i32(v, like: Tensor) -> Tensor:
    return _full(v, like, torch.int32)


def _false(like: Tensor) -> Tensor:
    return _full(False, like, torch.bool)


def _pick(v: Tensor, idx: Tensor) -> Tensor:
    """v[..., idx] per lane: v is (..., K), idx an index per lane; a gather,
    with no host read."""
    return v.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def _first(mask: Tensor) -> Tensor:
    """Index of each lane's first True of a (..., K) mask (0 when there is
    none)."""
    return torch.argmax(mask.to(torch.int32), dim=-1)


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


# --- 1. Armijo backtracking ---------------------------------------------------

@lru_cache(maxsize=8)
def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


@lru_cache(maxsize=64)
def _ladder_values(initial_step: float, shrink: float, tol: float,
                   np_dtype: np.dtype) -> tuple[np.ndarray, float]:
    """(trials, underflowed): every alpha the loop can test, in its order,
    and the untested alpha it returns when none is accepted."""
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
    return np.array(trials, np_dtype), float(nxt)


@lru_cache(maxsize=64)
def _ladder(initial_step: float, shrink: float, tol: float,
            dtype: torch.dtype, device: torch.device) -> tuple[Tensor, float]:
    """``_ladder_values`` on the device.  Cached, so the host-to-device
    copy happens once per configuration and device."""
    trials, underflowed = _ladder_values(initial_step, shrink, tol,
                                         _np_dtype(dtype))
    _refuse_capture("the backtracking ladder")
    return torch.tensor(trials, device=device), underflowed


def _ladder_len(cfg: LBFGSConfig, dtype: torch.dtype) -> int:
    """The number of trials the backtracking loop can make: its trip
    bound."""
    return len(_ladder_values(cfg.initial_step, cfg.shrink,
                              cfg.backtracking_tol, _np_dtype(dtype))[0])


def _backtracking_ladder(cfg: LBFGSConfig, phi: Callable[[Tensor], Tensor],
                         f_x: Tensor, g_dot_d: Tensor) -> LineSearchResult:
    """Armijo backtracking over the whole ladder at once; ``phi`` takes the
    (..., K) ladder, the same K steps for every lane, and returns (..., K)."""
    alphas, underflowed = _ladder(cfg.initial_step, cfg.shrink,
                                  cfg.backtracking_tol, f_x.dtype, f_x.device)
    trials = alphas.expand(f_x.shape + alphas.shape) if f_x.dim() else alphas
    accept = _armijo_accept(cfg, per_lane(f_x), phi(trials), alphas,
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


def _backtracking_loop(cfg: LBFGSConfig, phi, f_x: Tensor, g_dot_d: Tensor,
                       bounded: bool) -> LineSearchResult:
    """The reference's loop (strategies.py:112-142): test alpha; accept and
    stop, or shrink it and stop untested once it underflows
    backtracking_tol.  One trial, one pass over (x, d), per turn; the
    ladder's length bounds the turns."""
    def cond(c):
        _, accepted, broke, _ = c
        return ~(accepted | broke)

    def body(c):
        alpha, _, _, n_fev = c
        f_new = phi(alpha)
        accept = _armijo_accept(cfg, f_x, f_new, alpha, g_dot_d)
        alpha_next = torch.where(accept, alpha, alpha * cfg.shrink)
        broke = ~accept & (alpha_next < cfg.backtracking_tol)
        return alpha_next, accept, broke, n_fev + 1

    alpha, _, broke, n_fev = _loop(
        cond, body, (_full(cfg.initial_step, f_x), _false(f_x), _false(f_x),
                     _i32(0, f_x)), _ladder_len(cfg, f_x.dtype), bounded,
        enter=True)
    if cfg.fidelity == "fixed" and cfg.alpha_rescue_floor is None:
        # Textbook semantics: a search that never satisfied Armijo fails
        # (alpha = 0, the solver bails) instead of stepping on the untested
        # underflowed alpha the reference returns (line_search.cpp:29).
        alpha = torch.where(broke, torch.zeros_like(alpha), alpha)
    alpha, rescued = _apply_rescue(cfg, alpha)
    return LineSearchResult(alpha, n_fev, _i32(0, f_x), rescued)


def backtracking(cfg: LBFGSConfig, phi, phi_dphi, f_x: Tensor,
                 g_dot_d: Tensor, bounded: bool = False) -> LineSearchResult:
    """Armijo backtracking: the whole ladder at once under
    ``ls_eval="polynomial"`` or for a batch of lanes (no host read under
    either loop: a batch's ladder is its fixed-trip form), the
    reference's loop for one instance under ``"direct"`` (one pass over
    (x, d) per trial, not 27).  All give the loop's result."""
    del phi_dphi
    if cfg.ls_eval == "polynomial" or f_x.dim():
        return _backtracking_ladder(cfg, phi, f_x, g_dot_d)
    return _backtracking_loop(cfg, phi, f_x, g_dot_d, bounded)


# --- 1b. Speculative (batched-candidate) Armijo backtracking -----------------

def backtracking_speculative(cfg: LBFGSConfig, phi, phi_dphi, f_x: Tensor,
                             g_dot_d: Tensor,
                             bounded: bool = False) -> LineSearchResult:
    """Armijo backtracking with each round's ladder alpha_base *
    shrink^[0..K) evaluated by one vector ``phi`` call: under
    ``ls_eval="direct"`` one pass over (x, d) for K trials
    (``problems.suite.multi_phi_for``, the ``rosenbrock_multi_phi``
    kernel on the card).

    The returned alpha is exactly sequential backtracking's: the first
    ladder index that passes Armijo wins, and the sequential loop's
    underflow exit is reproduced per candidate.  The ladder is the loop's
    own chain of multiplications in the working dtype (a pow-based ladder
    rounds differently for a shrink that is no power of two).  n_fev counts
    the evaluations performed, K per round; the rounds are at most the
    sequential ladder's length over K.
    """
    del phi_dphi
    K = cfg.spec_width
    shrink = _full(cfg.shrink, f_x)

    def ladder(base):
        alphas = []
        for _ in range(K):
            alphas.append(base)
            base = base * shrink
        return torch.stack(alphas, dim=-1)

    def cond(c):
        return ~c[1]

    def body(c):
        base, _, _, _, n_fev = c
        alphas = ladder(base)                        # (..., K)
        fs = phi(alphas)                             # one batched pass
        accepts = _armijo_accept(cfg, per_lane(f_x), fs, alphas,
                                 per_lane(g_dot_d))
        nexts = alphas * cfg.shrink
        breaks = ~accepts & (nexts < cfg.backtracking_tol)
        stop = accepts | breaks
        idx = _first(stop)
        accept_idx = _pick(accepts, idx)
        res = torch.where(accept_idx, _pick(alphas, idx), _pick(nexts, idx))
        return (nexts[..., K - 1], stop.any(-1), res, ~accept_idx,
                n_fev + K)

    alpha0 = _full(cfg.initial_step, f_x)
    _, _, alpha, broke, n_fev = _loop(
        cond, body, (alpha0, _false(f_x), alpha0, _false(f_x), _i32(0, f_x)),
        -(-_ladder_len(cfg, f_x.dtype) // K), bounded, enter=True)
    if cfg.fidelity == "fixed" and cfg.alpha_rescue_floor is None:
        # The same textbook break-means-fail semantics as `backtracking`.
        alpha = torch.where(broke, torch.zeros_like(alpha), alpha)
    alpha, rescued = _apply_rescue(cfg, alpha)
    return LineSearchResult(alpha, n_fev, _i32(0, f_x), rescued)


# --- 2. Backtracking-Wolfe (multiplicative shrink / grow) --------------------

def backtracking_wolfe(cfg: LBFGSConfig, phi, phi_dphi, f_x: Tensor,
                       g_dot_d: Tensor,
                       bounded: bool = False) -> LineSearchResult:
    """Armijo fail -> alpha *= shrink; curvature fail -> alpha *= grow.  The
    reference's loop has no cap (line_search.cpp:39-52); cfg.ls_safety_cap
    bounds it."""
    del phi

    def cond(c):
        _, done, it, _, _ = c
        return ~done & (it < cfg.ls_safety_cap)

    def body(c):
        alpha, _, it, n_fev, n_gev = c
        f_new, dphi_new = phi_dphi(alpha)
        armijo_fail = f_new > f_x + cfg.c1 * alpha * g_dot_d
        curv_fail = dphi_new < cfg.c2 * g_dot_d
        alpha_next = torch.where(
            armijo_fail, alpha * cfg.shrink,
            torch.where(curv_fail, alpha * cfg.grow, alpha))
        accepted = ~armijo_fail & ~curv_fail
        done = accepted | (alpha_next < cfg.backtracking_tol)
        return alpha_next, done, it + 1, n_fev + 1, n_gev + 1

    zero = _i32(0, f_x)
    alpha, _, _, n_fev, n_gev = _loop(
        cond, body, (_full(cfg.initial_step, f_x), _false(f_x), zero, zero,
                     zero), cfg.ls_safety_cap, bounded,
        enter=cfg.ls_safety_cap > 0)
    return LineSearchResult(alpha, n_fev, n_gev, zero)


# --- 3. Backtracking-Wolfe by bisection (the parallel implementation) --------

def backtracking_wolfe_bisect(cfg: LBFGSConfig, phi, phi_dphi, f_x: Tensor,
                              g_dot_d: Tensor,
                              bounded: bool = False) -> LineSearchResult:
    """Bisection on [alpha_lo, alpha_hi], doubling while no upper bound
    exists.  The reference's function hard-codes C2 = 0.9 (parallel
    line_search.cpp:54); pass cfg.c2 = 0.9 for that code path."""
    del phi
    big = _full(torch.finfo(f_x.dtype).max, f_x)

    def cond(c):
        _, _, _, done, it, _, _ = c
        return ~done & (it < cfg.ls_max_iters)

    def body(c):
        alpha, lo, hi, _, it, n_fev, n_gev = c
        f_new, gnd = phi_dphi(alpha)
        armijo_ok = f_new <= f_x + cfg.c1 * alpha * g_dot_d
        curv_ok = gnd >= cfg.c2 * g_dot_d
        accepted = armijo_ok & curv_ok
        lo = torch.where(armijo_ok & ~curv_ok, alpha, lo)
        hi = torch.where(~armijo_ok, alpha, hi)
        alpha_next = torch.where(hi < big, (lo + hi) * 0.5, 2.0 * lo)
        alpha_next = torch.where(accepted, alpha, alpha_next)
        done = accepted | (alpha_next < cfg.bisect_tol)
        # The reference evaluates the gradient only when Armijo passes
        # (line_search.cpp:116-118).
        return (alpha_next, lo, hi, done, it + 1, n_fev + 1,
                n_gev + armijo_ok.to(torch.int32))

    zero = _i32(0, f_x)
    alpha, _, _, _, _, n_fev, n_gev = _loop(
        cond, body, (_full(cfg.initial_step, f_x), _full(0.0, f_x), big,
                     _false(f_x), zero, zero, zero), cfg.ls_max_iters,
        bounded, enter=cfg.ls_max_iters > 0)
    return LineSearchResult(alpha, n_fev, n_gev, zero)


# --- 4. Armijo with quadratic-then-cubic interpolation -----------------------

def armijo_interpolation(cfg: LBFGSConfig, phi, phi_dphi, f_x: Tensor,
                         g_dot_d: Tensor,
                         bounded: bool = False) -> LineSearchResult:
    del phi_dphi
    dtype = f_x.dtype

    def cond(c):
        _, _, _, done, _, it, _ = c
        return ~done & (it < cfg.ls_max_iters)

    def body(c):
        alpha, alpha_prev, f_prev, _, result, it, n_fev = c
        f_new = phi(alpha)
        accept = f_new <= f_x + cfg.c1 * alpha * g_dot_d
        floor_hit = ~accept & (alpha < cfg.interp_min)

        # --- cubic branch (a previous trial exists) ---
        delta = alpha - alpha_prev
        degenerate = torch.abs(delta) < 1e-10
        grad_alpha = (f_new - f_x - g_dot_d * alpha) / (alpha * alpha)
        # Traps 4 and 5: the reference's cubic returns the maximizer root
        # and its quadratic a step larger than alpha; "fixed" takes the
        # textbook minimizers (the same safeguard bands either way).
        if cfg.fidelity == "fixed":
            a_cubic = cubic_interpolate_fixed(alpha_prev, alpha, f_prev,
                                              g_dot_d, f_new, grad_alpha)
        else:
            a_cubic = cubic_interpolate(alpha_prev, alpha, f_prev, g_dot_d,
                                        f_new, grad_alpha)
        # The band is relative to alpha_prev (line_search.cpp:103); NaN
        # compares False, so a NaN survives it, as in the reference.
        out_of_band = ((a_cubic < 0.1 * alpha_prev)
                       | (a_cubic > 0.9 * alpha_prev))
        a_cubic = torch.where(out_of_band, alpha_prev * 0.5, a_cubic)
        a_from_cubic = torch.where(degenerate, alpha * 0.5, a_cubic)

        # --- quadratic branch (the first failed trial) ---
        if cfg.fidelity == "fixed":
            a_quad = quadratic_interpolate_fixed(alpha, f_x, g_dot_d, f_new)
        else:
            a_quad = quadratic_interpolate(alpha, _full(0.0, f_x), f_new,
                                           g_dot_d, f_x)
        out_q = ((a_quad < 0.1 * cfg.initial_step)
                 | (a_quad > 0.9 * cfg.initial_step))
        a_quad = torch.where(out_q, cfg.initial_step * 0.5, a_quad)

        alpha_next = torch.where(alpha_prev > 0, a_from_cubic, a_quad)
        # Trap 2 (line_search.cpp:116): alpha_prev tracks the NEW alpha, so
        # delta collapses to 0 next turn and the search halves from then on.
        alpha_prev_next = alpha_next if cfg.fidelity == "reference" else alpha

        done = accept | floor_hit
        result = torch.where(
            accept, alpha,
            torch.where(floor_hit, _full(cfg.interp_min, f_x, dtype),
                        alpha_next))
        return (alpha_next, alpha_prev_next, f_new, done, result, it + 1,
                n_fev + 1)

    alpha0 = _full(cfg.initial_step, f_x)
    zero = _i32(0, f_x)
    alpha, _, _, done, result, _, n_fev = _loop(
        cond, body, (alpha0, _full(0.0, f_x), f_x, _false(f_x), alpha0, zero,
                     zero), cfg.ls_max_iters, bounded,
        enter=cfg.ls_max_iters > 0)
    # On cap exhaustion the reference returns the current alpha
    # (line_search.cpp:120); only that path goes through the parallel
    # implementation's floor rescue (parallel line_search.cpp:223-227).
    rescued_alpha, hit = _apply_rescue(cfg, alpha)
    return LineSearchResult(torch.where(done, result, rescued_alpha), n_fev,
                            zero, torch.where(done, zero, hit))


# --- 5. Strong Wolfe with cubic interpolation (zoom) -------------------------

def _wolfe_interp_fn(cfg: LBFGSConfig):
    if cfg.safe_cubic:
        fixed = cfg.fidelity == "fixed"
        return lambda *a: safe_cubic_interpolate(*a, fixed=fixed)
    if cfg.fidelity == "fixed":
        return cubic_interpolate_fixed         # trap 4: the minimizer root
    return cubic_interpolate


def _make_wolfe_zoom(cfg: LBFGSConfig, phi_dphi, f_x: Tensor,
                     g_dot_d: Tensor, interp):
    """(cond, body) of the strong-Wolfe zoom loop: the one source of the
    sequential branch rules, shared by ``wolfe_interpolation`` and the
    speculative twin's phase B."""
    interp_min = _full(cfg.interp_min, f_x)

    def cond(c):
        return ~c[5] & (c[7] < cfg.ls_max_iters)

    def body(c):
        alpha, lo, hi, f_lo, dphi_lo, _, result, it, n_fev, n_gev = c
        f_new, dphi_new = phi_dphi(alpha)
        # Branch 1: Armijo violated, or no improvement over the lo point.
        branch1 = ((f_new > f_x + cfg.c1 * alpha * g_dot_d)
                   | ((f_new >= f_lo) & (it > 0)))
        grad_alpha = (f_new - f_x - g_dot_d * alpha) / (alpha * alpha)
        a_b1 = interp(lo, alpha, f_lo, dphi_lo, f_new, grad_alpha)
        accepted = ~branch1 & (torch.abs(dphi_new) <= -cfg.c2 * g_dot_d)

        # Branch 2: the curvature's sign flipped; alpha is the new hi.
        branch2 = ~branch1 & ~accepted & (dphi_new >= 0)
        a_b2 = interp(lo, alpha, f_lo, dphi_lo, f_new, dphi_new)

        # Branch 3: still descending; alpha is the new lo.  Double while
        # unbounded above, else interpolate against hi, with the UPDATED
        # lo / f_lo / dphi_lo (line_search.cpp:171-180).
        branch3 = ~branch1 & ~accepted & ~branch2
        a_b3 = torch.where(torch.isinf(hi), alpha * 2.0,
                           interp(alpha, hi, f_new, dphi_new, f_new,
                                  dphi_new))

        hi_next = torch.where(branch1 | branch2, alpha, hi)
        lo_next = torch.where(branch3, alpha, lo)
        f_lo_next = torch.where(branch3, f_new, f_lo)
        dphi_lo_next = torch.where(branch3, dphi_new, dphi_lo)

        alpha_next = torch.where(
            branch1, a_b1,
            torch.where(branch2, a_b2, torch.where(branch3, a_b3, alpha)))
        # No interp_min check on branch 1 (its `continue` at
        # line_search.cpp:156 skips it).
        floor_hit = ~branch1 & ~accepted & (alpha_next < cfg.interp_min)

        done = accepted | floor_hit
        result = torch.where(accepted, alpha,
                             torch.where(floor_hit, interp_min, result))
        # The reference evaluates the gradient only off branch 1.
        return (alpha_next, lo_next, hi_next, f_lo_next, dphi_lo_next, done,
                result, it + 1, n_fev + 1,
                n_gev + (~branch1).to(torch.int32))

    return cond, body


def wolfe_interpolation(cfg: LBFGSConfig, phi, phi_dphi, f_x: Tensor,
                        g_dot_d: Tensor,
                        bounded: bool = False) -> LineSearchResult:
    del phi
    cond, body = _make_wolfe_zoom(cfg, phi_dphi, f_x, g_dot_d,
                                  _wolfe_interp_fn(cfg))
    alpha0 = _full(cfg.initial_step, f_x)
    zero = _i32(0, f_x)
    alpha, _, _, _, _, done, result, _, n_fev, n_gev = _loop(
        cond, body, (alpha0, _full(0.0, f_x), _full(math.inf, f_x), f_x,
                     g_dot_d, _false(f_x), alpha0, zero, zero, zero),
        cfg.ls_max_iters, bounded, enter=cfg.ls_max_iters > 0)
    return LineSearchResult(torch.where(done, result, alpha), n_fev, n_gev,
                            zero)


# --- 5b. Speculative strong Wolfe: K-wide bracketing ladder + the zoom -------

def wolfe_interpolation_speculative(cfg: LBFGSConfig, phi, phi_dphi,
                                    f_x: Tensor, g_dot_d: Tensor,
                                    bounded: bool = False
                                    ) -> LineSearchResult:
    """Strong Wolfe with the bracketing phase speculated K trials at a
    time.

    The sequential search brackets by pure doubling (branch 3 with hi = inf
    doubles alpha), a fixed ladder alpha0 * 2^[0..K) whose (phi, phi')
    values come from one pass over (x, d) (``problems.suite.
    multi_phi_dphi_for``, the ``rosenbrock_multi_phi_dphi`` kernel on the
    card).  Phase A resolves the ladder with the sequential branch rules,
    so the bracket, the zoom's entry state and the final alpha equal
    ``wolfe_interpolation``'s; phase B is the sequential zoom itself
    (``_make_wolfe_zoom``), one trial at a time.  n_fev / n_gev count the
    evaluations performed, K per ladder.  Phase A takes at most
    ceil(ls_max_iters / K) rounds (each round that does not stop advances
    the trial count by K), phase B at most ls_max_iters turns.
    """
    del phi
    K = cfg.spec_width
    cap = cfg.ls_max_iters
    interp = _wolfe_interp_fn(cfg)
    interp_min = _full(cfg.interp_min, f_x)
    t_idx = torch.arange(K, dtype=torch.int32, device=f_x.device)
    f_x_l, g_dot_d_l = per_lane(f_x), per_lane(g_dot_d)

    def ladder(base):
        # Iterated doubling, exact in floating point.
        alphas = []
        for _ in range(K):
            alphas.append(base)
            base = base * 2.0
        return torch.stack(alphas, dim=-1)

    # --- phase A: speculative bracketing -----------------------------------
    # carry: (base, bracketing, done, result, alpha_z, lo, hi, f_lo, dphi_lo,
    #         it, n_fev, n_gev)
    def condA(c):
        return c[1] & ~c[2] & (c[9] < cap)

    def condB_entry(c):
        return ~c[2] & (c[9] < cap)

    def bodyA(c):
        (base, bracketing, done, result, alpha_z, lo, hi, f_lo, dphi_lo,
         it, n_fev, n_gev) = c
        alphas = ladder(base)                      # (..., K)
        fs, dphis = phi_dphi(alphas)               # one K-trial pass
        it_t = per_lane(it) + t_idx
        # The previous node's values per ladder position (node 0 sees the
        # entering lo state).
        f_prev = torch.cat([f_lo[..., None], fs[..., :-1]], -1)
        dphi_prev = torch.cat([dphi_lo[..., None], dphis[..., :-1]], -1)
        lo_prev = torch.cat([lo[..., None], alphas[..., :-1]], -1)

        branch1 = ((fs > f_x_l + cfg.c1 * alphas * g_dot_d_l)
                   | ((fs >= f_prev) & (it_t > 0)))
        accepted = ~branch1 & (torch.abs(dphis) <= -cfg.c2 * g_dot_d_l)
        branch2 = ~branch1 & ~accepted & (dphis >= 0)
        # The sequential loop checks alpha_next (2 alpha while doubling)
        # against interp_min on every step off branch 1, so a doubling node
        # can floor out (initial_step < interp_min).
        b3_floor = (~branch1 & ~accepted & ~branch2
                    & (alphas * 2.0 < cfg.interp_min))
        cap_hit = it_t >= cap        # the sequential loop stopped before it
        stop = branch1 | accepted | branch2 | b3_floor | cap_hit
        any_stop = stop.any(-1)
        t = _first(stop)

        a_t, f_t, dphi_t = _pick(alphas, t), _pick(fs, t), _pick(dphis, t)
        lo_t, f_lo_t, dphi_lo_t = (_pick(lo_prev, t), _pick(f_prev, t),
                                   _pick(dphi_prev, t))

        # Outcomes at the stop node (cap_hit first: those trials never ran).
        capped = _pick(cap_hit, t)
        acc = ~capped & _pick(accepted, t)
        b1 = ~capped & _pick(branch1, t)
        b2 = ~capped & _pick(branch2, t)
        b3f = ~capped & _pick(b3_floor, t)

        grad_alpha = (f_t - f_x - g_dot_d * a_t) / (a_t * a_t)
        a_b1 = interp(lo_t, a_t, f_lo_t, dphi_lo_t, f_t, grad_alpha)
        a_b2 = interp(lo_t, a_t, f_lo_t, dphi_lo_t, f_t, dphi_t)
        alpha_next = torch.where(b1, a_b1, torch.where(b2, a_b2, a_t))
        # No floor check on branch 1 (the reference's `continue`).
        floor_hit = (b2 & (alpha_next < cfg.interp_min)) | b3f

        done_now = any_stop & (acc | floor_hit | capped)
        result_now = torch.where(
            acc, a_t,
            torch.where(floor_hit, interp_min,
                        torch.where(capped, a_t, result)))
        enter_zoom = any_stop & (b1 | b2) & ~floor_hit

        # No stop: the whole ladder was branch 3; the walk advances by K.
        tail_a, tail_f, tail_d = (alphas[..., K - 1], fs[..., K - 1],
                                  dphis[..., K - 1])
        base_next = torch.where(any_stop, base, tail_a * 2.0)
        lo_next = torch.where(any_stop, torch.where(enter_zoom, lo_t, lo),
                              tail_a)
        f_lo_next = torch.where(any_stop,
                                torch.where(enter_zoom, f_lo_t, f_lo), tail_f)
        dphi_lo_next = torch.where(
            any_stop, torch.where(enter_zoom, dphi_lo_t, dphi_lo), tail_d)
        hi_next = torch.where(enter_zoom, a_t, hi)
        it_next = torch.where(any_stop,
                              torch.clamp(_pick(it_t, t) + 1, max=cap),
                              it + K)
        it_next = torch.where(capped, cap, it_next)
        return (base_next, bracketing & ~any_stop, done_now, result_now,
                torch.where(enter_zoom, alpha_next, base_next), lo_next,
                hi_next, f_lo_next, dphi_lo_next, it_next.to(torch.int32),
                n_fev + K, n_gev + K)

    alpha0 = _full(cfg.initial_step, f_x)
    zero = _i32(0, f_x)
    c = (alpha0, _full(True, f_x, torch.bool), _false(f_x), alpha0, alpha0,
         _full(0.0, f_x), _full(math.inf, f_x), f_x, g_dot_d, zero, zero,
         zero)
    go_b = None
    if bounded:
        c = _loop(condA, bodyA, c, -(-cap // K), True)
    else:
        # Each round reads phase A's condition and, for the exit, phase B's
        # entry condition in the same transfer.
        lanes = f_x.dim() > 0
        go = condA(c) if lanes else None
        go_a = go_b = cap > 0
        while go_a:
            new = bodyA(c)
            c = _select(go, new, c) if lanes else new
            go = condA(c)
            go_a, go_b = _read(go, condB_entry(c))
    (_, _, done, result, alpha_z, lo, hi, f_lo, dphi_lo, it, n_fev,
     n_gev) = c

    # --- phase B: the sequential zoom from the speculated bracket ----------
    condB, bodyB = _make_wolfe_zoom(cfg, phi_dphi, f_x, g_dot_d, interp)
    alpha, _, _, _, _, done, result, _, n_fev, n_gev = _loop(
        condB, bodyB,
        (alpha_z, lo, hi, f_lo, dphi_lo, done, result, it, n_fev, n_gev),
        cap, bounded, enter=go_b)
    return LineSearchResult(torch.where(done, result, alpha), n_fev, n_gev,
                            zero)


# --- 2b. Speculative backtracking-Wolfe: the walk speculated as a tree -------

@lru_cache(maxsize=64)
def _tree_tables(R: int, device: torch.device):
    """The triangular node table of ``backtracking_wolfe_speculative`` in
    walk order, node t = (i shrinks, j grows), i + j <= R, on the device:
    (index of (i, j) in the (R+1, R+1) level grid, index of the shrink child,
    index of the grow child, whether each child is in the tree, node
    indices).  Cached, so the copy happens once per R and device."""
    _refuse_capture("the backtracking_wolfe_speculative node table")
    pairs = [(i, j) for i in range(R + 1) for j in range(R + 1 - i)]
    flat = {p: t for t, p in enumerate(pairs)}

    def on(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return (on([i * (R + 1) + j for i, j in pairs], torch.int64),
            on([flat.get((i + 1, j), 0) for i, j in pairs], torch.int64),
            on([flat.get((i, j + 1), 0) for i, j in pairs], torch.int64),
            on([(i + 1, j) in flat for i, j in pairs], torch.bool),
            on([(i, j + 1) in flat for i, j in pairs], torch.bool),
            on(list(range(len(pairs))), torch.int64))


def backtracking_wolfe_speculative(cfg: LBFGSConfig, phi, phi_dphi,
                                   f_x: Tensor, g_dot_d: Tensor,
                                   bounded: bool = False
                                   ) -> LineSearchResult:
    """``backtracking_wolfe`` with its multiplicative walk speculated.

    After R steps the walk's reachable states are base * shrink^i * grow^j
    with i + j <= R: a triangular tree of (R+1)(R+2)/2 nodes, 36 at the
    default R = spec_width - 1 = 7, whose (phi, phi') values come from one
    pass over (x, d).  The walk is then replayed on them with the
    sequential rules, up to R + 1 real steps per pass; a pass that does not
    end the walk takes all R + 1 (its last step leaves the tree), so the
    passes are at most ceil(ls_safety_cap / (R + 1)).

    The values are the walk's own only for a power-of-two shrink (the
    default 0.5): multiplying by it is exact, so every interleaving of
    shrinks and grows that reaches (i, j) rounds alike.  For any other
    shrink this delegates to ``backtracking_wolfe``.
    """
    if math.frexp(cfg.shrink)[0] != 0.5:       # not a power of two
        return backtracking_wolfe(cfg, phi, phi_dphi, f_x, g_dot_d, bounded)
    del phi
    R = max(1, cfg.spec_width - 1)
    cap = cfg.ls_safety_cap
    (grid_idx, idx_shrink, idx_grow, can_shrink, can_grow,
     nodes) = _tree_tables(R, f_x.device)
    K = nodes.shape[0]
    f_x_l, g_dot_d_l = per_lane(f_x), per_lane(g_dot_d)

    def tree(base):
        # The grow chain by iterated multiplication (base * grow * grow,
        # never base * (grow * grow)); then i halvings of every level, each
        # one elementwise multiplication, as the sequential walk applies
        # them.
        grows = []
        for _ in range(R + 1):
            grows.append(base)
            base = base * cfg.grow
        levels = [torch.stack(grows, dim=-1)]
        for _ in range(R):
            levels.append(levels[-1] * cfg.shrink)
        grid = torch.stack(levels, dim=-2)
        return grid.reshape(grid.shape[:-2] + (-1,)).index_select(-1,
                                                                  grid_idx)

    def cond(c):
        return ~c[1] & (c[2] < cap)

    def body(c):
        base, _, it, alpha_cur, n_fev, n_gev = c
        alphas = tree(base)                        # (..., K)
        fs, dphis = phi_dphi(alphas)               # one K-trial pass
        armijo_fail = fs > f_x_l + cfg.c1 * alphas * g_dot_d_l
        curv_fail = dphis < cfg.c2 * g_dot_d_l

        # What one sequential step does at each node (it depends on the
        # node alone): accept, shrink or grow; its next alpha, whether it
        # stops, whether the child lies in the evaluated tree.
        move_shrink = armijo_fail
        move_grow = ~armijo_fail & curv_fail
        acc = ~armijo_fail & ~curv_fail
        a_next = torch.where(
            move_shrink, alphas * cfg.shrink,
            torch.where(move_grow, alphas * cfg.grow, alphas))
        new_done = acc | (~acc & (a_next < cfg.backtracking_tol))
        child_in = torch.where(move_shrink, can_shrink,
                               move_grow & can_grow)
        t_next = torch.where(move_shrink, idx_shrink,
                             torch.where(move_grow, idx_grow, nodes))

        # Replay the walk: each live step is one sequential iteration;
        # `repass` marks a move whose child lies outside the tree (resume
        # from its value next pass).
        t = torch.zeros(f_x.shape, dtype=torch.int64, device=f_x.device)
        done, repass = _false(f_x), _false(f_x)
        it_s, alpha_s, base_n = it, alpha_cur, base
        for _ in range(R + 1):
            live = ~done & ~repass & (it_s < cap)
            nd, an = _pick(new_done, t), _pick(a_next, t)
            ci, tn = _pick(child_in, t), _pick(t_next, t)
            t = torch.where(live & ~nd & ci, tn, t)
            done = torch.where(live, nd, done)
            it_s = it_s + live.to(it_s.dtype)
            alpha_s = torch.where(live, an, alpha_s)
            repass = repass | (live & ~nd & ~ci)
            base_n = torch.where(live & ~nd, an, base_n)
        return base_n, done, it_s, alpha_s, n_fev + K, n_gev + K

    alpha0 = _full(cfg.initial_step, f_x)
    zero = _i32(0, f_x)
    _, _, _, alpha, n_fev, n_gev = _loop(
        cond, body, (alpha0, _false(f_x), zero, alpha0, zero, zero),
        -(-cap // (R + 1)), bounded, enter=cap > 0)
    return LineSearchResult(alpha, n_fev, n_gev, zero)


_STRATEGIES = {
    "backtracking": backtracking,
    "backtracking_speculative": backtracking_speculative,
    "backtracking_wolfe": backtracking_wolfe,
    "backtracking_wolfe_speculative": backtracking_wolfe_speculative,
    "backtracking_wolfe_bisect": backtracking_wolfe_bisect,
    "armijo_interpolation": armijo_interpolation,
    "wolfe_interpolation": wolfe_interpolation,
    "wolfe_interpolation_speculative": wolfe_interpolation_speculative,
}


def get_line_search(name: str):
    return _STRATEGIES[name]


# --- the speculative-selection rule -------------------------------------------
# The reference's measured boundary (tpu_lbfgs.linesearch.strategies): a
# speculative Wolfe twin wins only where the search makes many trials per
# iteration.  Its threshold was measured on a TPU v5e; the rule is ported as
# it is, and the H100's own boundary is not measured yet.
SPECULATIVE_TRIALS_THRESHOLD = 8.0
SPECULATIVE_TWINS = {
    "wolfe_interpolation": "wolfe_interpolation_speculative",
    "backtracking_wolfe": "backtracking_wolfe_speculative",
}


def resolve_speculative_auto(cfg: LBFGSConfig, probe_result) -> LBFGSConfig:
    """``cfg`` with its Wolfe search switched to the speculative twin
    exactly when a completed probe solve with the sequential search (for
    example ``cfg.replace(max_iters=50)``) made at least
    SPECULATIVE_TRIALS_THRESHOLD line-search trials per iteration, estimated
    as ``n_fev / iterations - 1`` (iterate charges one evaluation after
    each search).  Only meaningful under ``ls_eval="direct"``; other
    searches are returned unchanged."""
    twin = SPECULATIVE_TWINS.get(cfg.line_search)
    if twin is None:
        return cfg
    iters = max(int(probe_result.iterations), 1)
    trials_per_iter = int(probe_result.n_fev) / iters - 1.0
    if trials_per_iter >= SPECULATIVE_TRIALS_THRESHOLD:
        return cfg.replace(line_search=twin)
    return cfg
