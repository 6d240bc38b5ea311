"""NumPy oracle: a straight-line, host-side implementation of the reference
algorithm, the trajectory-parity target of the solver (the port's own copy
of ``tpu_lbfgs.oracle``, on the port's ``config.LBFGSConfig``).

It specifies the reference's exact decision rules
(sequential-implementation/lbfgs.cpp:17-203 and both line_search.cpp
files) in NumPy with plain Python control flow: ``goto``s become early
returns, deques become lists.  Its arithmetic is numpy's and ``math``'s
(no torch), operation for operation that of ``tpu_lbfgs.oracle``, so the
two give the same iterates bit for bit.

A C++ oracle with the same semantics, ``native/oracle.cpp``, is bound by
``tpu_lbfgs_torch.native`` and is the CPU baseline of the benchmarks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from .config import LBFGSConfig


# --- interpolators (line_search.cpp:8-16; parallel :231-296) --------------------

def cubic_interpolate(a0, a1, p0, dp0, p1, dp1):
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / (a1 - a0)
    disc = d1 * d1 - dp0 * dp1
    root = math.sqrt(disc) if disc >= 0 else float("nan")
    d2 = math.copysign(root, a1 - a0)
    return a0 + (a1 - a0) * (dp0 + d2 - d1) / (dp0 - dp1 + 2.0 * d2)


def cubic_interpolate_fixed(a0, a1, p0, dp0, p1, dp1):
    """Textbook minimizer root (N&W eq. 3.59) — fidelity="fixed" (trap #4:
    the reference's variant above returns the maximizer)."""
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / (a1 - a0)
    disc = d1 * d1 - dp0 * dp1
    root = math.sqrt(disc) if disc >= 0 else float("nan")
    d2 = math.copysign(root, a1 - a0)
    return a1 - (a1 - a0) * (dp1 + d2 - d1) / (dp1 - dp0 + 2.0 * d2)


def quadratic_interpolate(a0, a1, p0, dp0, p1):
    return a0 - 0.5 * dp0 * a0 * a0 / (p1 - p0 - dp0 * a0)


def quadratic_interpolate_fixed(alpha, p0, dp0, p_alpha):
    """Textbook one-point quadratic minimizer — fidelity="fixed" (trap #5)."""
    return -0.5 * dp0 * alpha * alpha / (p_alpha - p0 - dp0 * alpha)


def safe_cubic_interpolate(a0, a1, p0, dp0, p1, dp1, fixed=False):
    if a0 > a1:
        a0, a1 = a1, a0
        p0, p1 = p1, p0
        dp0, dp1 = dp1, dp0
    mid = 0.5 * (a0 + a1)
    span = a1 - a0
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / span if span != 0 else float("inf")
    if not math.isfinite(d1):
        return mid
    disc = d1 * d1 - dp0 * dp1
    if disc < 0:
        return mid
    d2 = math.copysign(math.sqrt(disc), span)
    if fixed:
        denom = dp1 - dp0 + 2.0 * d2
    else:
        denom = dp0 - dp1 + 2.0 * d2
    if abs(denom) < 1e-10:
        return mid
    if fixed:
        result = a1 - span * (dp1 + d2 - d1) / denom
    else:
        result = a0 + span * (dp0 + d2 - d1) / denom
    if not math.isfinite(result):
        return mid
    return max(a0 + 0.1 * span, min(a1 - 0.1 * span, result))


# --- line searches --------------------------------------------------------------

def ls_backtracking(cfg: LBFGSConfig, f, grad, x, d, f_x, g, gdd,
                    events=None):
    alpha = cfg.initial_step
    while True:
        f_new = f(x + alpha * d)
        if cfg.fidelity == "reference":
            accept = (f_x - f_new) >= cfg.c1 * alpha * gdd
        else:
            accept = f_new <= f_x + cfg.c1 * alpha * gdd
        if accept:
            break
        alpha *= cfg.shrink
        if alpha < cfg.backtracking_tol:
            break
    if cfg.alpha_rescue_floor is not None and alpha < cfg.alpha_rescue_floor:
        if events is not None:
            events["ls_rescue"] += 1
        return cfg.alpha_rescue_value
    return alpha


def ls_backtracking_wolfe(cfg: LBFGSConfig, f, grad, x, d, f_x, g, gdd):
    alpha = cfg.initial_step
    it = 0
    while it < cfg.ls_safety_cap:
        it += 1
        x_new = x + alpha * d
        g_new = grad(x_new)
        f_new = f(x_new)
        if f_new > f_x + cfg.c1 * alpha * gdd:
            alpha *= cfg.shrink
        elif float(np.dot(g_new, d)) < cfg.c2 * gdd:
            alpha *= cfg.grow
        else:
            break
        if alpha < cfg.backtracking_tol:
            break
    return alpha


def ls_backtracking_wolfe_bisect(cfg: LBFGSConfig, f, grad, x, d, f_x, g, gdd):
    alpha = cfg.initial_step
    lo, hi = 0.0, np.finfo(np.float64).max
    for _ in range(cfg.ls_max_iters):
        x_new = x + alpha * d
        f_new = f(x_new)
        if f_new <= f_x + cfg.c1 * alpha * gdd:
            gnd = float(np.dot(grad(x_new), d))
            if gnd >= cfg.c2 * gdd:
                break
            lo = alpha
        else:
            hi = alpha
        alpha = (lo + hi) / 2.0 if hi < np.finfo(np.float64).max else 2.0 * lo
        if alpha < cfg.bisect_tol:
            break
    return alpha


def ls_armijo_interpolation(cfg: LBFGSConfig, f, grad, x, d, f_x, g, gdd,
                            events=None):
    alpha = cfg.initial_step
    alpha_prev = 0.0
    f_prev = f_x
    for _ in range(cfg.ls_max_iters):
        alpha_tested = alpha
        f_new = f(x + alpha * d)
        if f_new <= f_x + cfg.c1 * alpha * gdd:
            return alpha
        if alpha < cfg.interp_min:
            return cfg.interp_min
        if alpha_prev > 0:
            if abs(alpha - alpha_prev) < 1e-10:
                alpha = alpha * 0.5
            else:
                grad_alpha = (f_new - f_x - gdd * alpha) / (alpha * alpha)
                cubic = (cubic_interpolate_fixed if cfg.fidelity == "fixed"
                         else cubic_interpolate)
                a = cubic(alpha_prev, alpha, f_prev, gdd, f_new, grad_alpha)
                # NaN comparisons are False, matching C++ (NaN passes through).
                if a < 0.1 * alpha_prev or a > 0.9 * alpha_prev:
                    a = alpha_prev * 0.5
                alpha = a
        else:
            if cfg.fidelity == "fixed":
                a = quadratic_interpolate_fixed(alpha, f_x, gdd, f_new)
            else:
                a = quadratic_interpolate(alpha, 0.0, f_new, gdd, f_x)
            if a < 0.1 * cfg.initial_step or a > 0.9 * cfg.initial_step:
                a = cfg.initial_step * 0.5
            alpha = a
        if cfg.fidelity == "reference":
            alpha_prev = alpha   # the reference's bookkeeping quirk
        else:
            alpha_prev = alpha_tested  # "fixed": track the tested point
        f_prev = f_new
    if cfg.alpha_rescue_floor is not None and alpha < cfg.alpha_rescue_floor:
        if events is not None:
            events["ls_rescue"] += 1
        return cfg.alpha_rescue_value
    return alpha


def ls_wolfe_interpolation(cfg: LBFGSConfig, f, grad, x, d, f_x, g, gdd):
    if cfg.safe_cubic:
        interp = lambda *a: safe_cubic_interpolate(
            *a, fixed=cfg.fidelity == "fixed")
    elif cfg.fidelity == "fixed":
        interp = cubic_interpolate_fixed
    else:
        interp = cubic_interpolate
    alpha = cfg.initial_step
    lo, hi = 0.0, float("inf")
    f_lo, dphi_lo = f_x, gdd
    for it in range(cfg.ls_max_iters):
        x_new = x + alpha * d
        f_new = f(x_new)
        if f_new > f_x + cfg.c1 * alpha * gdd or (f_new >= f_lo and it > 0):
            hi = alpha
            alpha = interp(lo, hi, f_lo, dphi_lo, f_new,
                           (f_new - f_x - gdd * alpha) / (alpha * alpha))
            continue
        dphi_new = float(np.dot(grad(x_new), d))
        if abs(dphi_new) <= -cfg.c2 * gdd:
            return alpha
        if dphi_new >= 0:
            hi = alpha
            alpha = interp(lo, hi, f_lo, dphi_lo, f_new, dphi_new)
        else:
            lo = alpha
            f_lo, dphi_lo = f_new, dphi_new
            if hi == float("inf"):
                alpha = alpha * 2.0
            else:
                alpha = interp(lo, hi, f_lo, dphi_lo, f_new, dphi_new)
        if alpha < cfg.interp_min:
            return cfg.interp_min
    return alpha


LINE_SEARCHES = {
    "backtracking": ls_backtracking,
    "backtracking_wolfe": ls_backtracking_wolfe,
    "backtracking_wolfe_bisect": ls_backtracking_wolfe_bisect,
    "armijo_interpolation": ls_armijo_interpolation,
    "wolfe_interpolation": ls_wolfe_interpolation,
}


# --- solver (lbfgs.cpp:17-203) ---------------------------------------------------

@dataclass
class OracleResult:
    x: np.ndarray
    f: float
    g_norm: float
    iterations: int
    status: str
    xs: List[np.ndarray] = field(default_factory=list)
    fs: List[float] = field(default_factory=list)
    g_norms: List[float] = field(default_factory=list)
    alphas: List[float] = field(default_factory=list)
    # Safeguard-activation counts, keyed like types.Guard.NAMES — the
    # reference's warning sites counted (lbfgs.cpp:105,121,150,194; parallel
    # line_search.cpp:38-41).  Parity target for SolveResult.guards.
    guard_counts: dict = field(default_factory=lambda: {
        "dir_fallback": 0, "not_descent": 0, "pair_reject": 0,
        "ls_rescue": 0, "lane_freeze": 0, "damped": 0})
    # "damped" stays 0: Powell damping is this framework's extension; the
    # reference (and so this oracle) can only reject low-curvature pairs.


def lbfgs_oracle(f: Callable, grad: Callable, x0: np.ndarray,
                 cfg: LBFGSConfig, record: bool = True) -> OracleResult:
    x = np.asarray(x0, np.float64).copy()
    f_current = float(f(x))
    g = np.asarray(grad(x), np.float64)
    s_hist: List[np.ndarray] = []
    y_hist: List[np.ndarray] = []
    line_search = LINE_SEARCHES[cfg.line_search]
    res = OracleResult(x, f_current, float(np.linalg.norm(g)), 0, "max_iters")

    for k in range(cfg.max_iters):
        g_norm = float(np.linalg.norm(g))
        if record:
            res.xs.append(x.copy())
            res.fs.append(f_current)
            res.g_norms.append(g_norm)
        if g_norm < cfg.tol:
            res.status = "converged"
            break

        # --- direction: two-loop with reference guards ---
        d = _direction(cfg, g, s_hist, y_hist, events=res.guard_counts)

        gdd = float(np.dot(g, d))
        if gdd >= 0:
            res.guard_counts["not_descent"] += 1   # lbfgs.cpp:150 warning
            d = -g
            gdd = float(np.dot(g, d))

        if line_search in (ls_backtracking, ls_armijo_interpolation):
            alpha = line_search(cfg, f, grad, x, d, f_current, g, gdd,
                                events=res.guard_counts)
        else:
            alpha = line_search(cfg, f, grad, x, d, f_current, g, gdd)
        if record:
            res.alphas.append(alpha)

        x_new = x + alpha * d
        f_current = float(f(x_new))
        if alpha < cfg.step_fail_tol:
            res.guard_counts["lane_freeze"] += 1
            res.status = "line_search_failed"
            break

        g_new = np.asarray(grad(x_new), np.float64)
        s = x_new - x
        y = g_new - g
        sy = float(np.dot(s, y))
        if sy > cfg.curvature_threshold:
            if len(s_hist) >= cfg.m:
                s_hist.pop(0)
                y_hist.pop(0)
            s_hist.append(s)
            y_hist.append(y)
        else:
            res.guard_counts["pair_reject"] += 1   # lbfgs.cpp:194 warning

        x, g = x_new, g_new
        res.iterations = k + 1

    res.x = x
    res.f = float(f(x))
    res.g_norm = float(np.linalg.norm(g))
    return res


def _direction(cfg: LBFGSConfig, g, s_hist, y_hist,
               events=None) -> np.ndarray:
    """Two-loop recursion with the CPU reference's guards (lbfgs.cpp:86-144).
    ``events``: optional guard-count dict; the invalid-rho/gamma fallbacks
    (the lbfgs.cpp:105,121 warnings) increment ``dir_fallback``.  The empty-
    history steepest-descent start is NOT counted — the reference does not
    warn there either."""
    def fell_back():
        if events is not None:
            events["dir_fallback"] += 1
        return -g

    if not s_hist:
        return -g
    h = len(s_hist)
    q = g.copy()
    alphas = np.zeros(h)
    skip = [False] * h
    for i in range(h - 1, -1, -1):
        sy = float(np.dot(y_hist[i], s_hist[i]))
        if cfg.pair_skip_threshold is not None:
            if sy <= cfg.pair_skip_threshold:
                skip[i] = True
                continue
        rho = 1.0 / sy if sy != 0 else float("inf")
        if not math.isfinite(rho):
            return fell_back()
        alphas[i] = rho * float(np.dot(s_hist[i], q))
        q -= alphas[i] * y_hist[i]
    sy_last = float(np.dot(s_hist[-1], y_hist[-1]))
    yy_last = float(np.dot(y_hist[-1], y_hist[-1]))
    gamma = sy_last / yy_last if yy_last != 0 else float("nan")
    if gamma <= 0 or not math.isfinite(gamma):
        return fell_back()
    r = gamma * q
    for i in range(h):
        if skip[i]:
            continue
        rho = 1.0 / float(np.dot(y_hist[i], s_hist[i]))
        beta = rho * float(np.dot(y_hist[i], r))
        r += s_hist[i] * (alphas[i] - beta)
    return -r
