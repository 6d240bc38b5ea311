"""A plain L-BFGS on the chained Rosenbrock function, the benchmark's
reference: the solve that a configuration and a traffic mix state, written
from the published algorithm in plain PyTorch, one operation at a time.

It imports nothing of the program under test.  It runs on any device and
in any floating dtype: float64 is the reference that a cell is judged
against; bfloat16 is the control (the reference put in the program's place
one precision below the float32 the configurations state), which the
comparison has to fail.

What it computes, for a batch of independent instances (B, d), each lane
on its own (a single instance is B = 1):

- the direction d = -H g by the two-loop recursion over the last m pairs
  (Nocedal and Wright, Algorithm 7.4), H0 = gamma I with gamma = s'y / y'y
  of the newest stored pair; steepest descent while no pair is stored, or
  where gamma is not positive and finite, or where d is not finite; pairs
  with s'y at or under ``pair_skip_threshold`` take no part, where it is
  set; a d that is no descent direction is replaced by -g;
- the line search, on phi(a) = f(x + a d) evaluated directly:
  ``backtracking`` (Armijo on the ladder a = initial_step * shrink^j down
  to ``backtracking_tol``, the first that passes), or
  ``wolfe_interpolation`` (strong Wolfe, bracketing by doubling, then the
  zoom with a safeguarded cubic, Nocedal and Wright Algorithms 3.5 and
  3.6, in the branch order of the paper's reference code);
- the step x += a d, and the pair (s, y) stored where s'y exceeds
  ``curvature_threshold``.

Armijo is tested as the configuration's ``fidelity`` says: "reference"
is the paper's reference code's rule (f(x) - f(x + a d) >= c1 a g'd,
sign and all), "fixed" the textbook one (f(x + a d) <= f(x) + c1 a g'd).
Under "reference" a ladder that no trial passes steps on the first value
under ``backtracking_tol``; under "fixed" the search fails.  A step under
``step_fail_tol``, or a non-finite f or gradient at the new point, fails
the lane: it keeps its point and stops.
"""
from __future__ import annotations

import math

import torch

RUNNING, MAX_ITERS, LINE_SEARCH_FAILED = "running", "max_iters", \
    "line_search_failed"


def rosenbrock_f(x: torch.Tensor) -> torch.Tensor:
    """sum_i 100 (x_{i+1} - x_i^2)^2 + (1 - x_i)^2 over the last axis."""
    a, b = x[..., :-1], x[..., 1:]
    return torch.sum(100.0 * (b - a * a) ** 2 + (1.0 - a) ** 2, dim=-1)


def rosenbrock_grad(x: torch.Tensor) -> torch.Tensor:
    a, b = x[..., :-1], x[..., 1:]
    t = b - a * a
    g = torch.zeros_like(x)
    g[..., :-1] = -400.0 * a * t - 2.0 * (1.0 - a)
    g[..., 1:] += 200.0 * t
    return g


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=-1)


def _col(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(-1)


def _direction(g, S, Y, sy, count, gamma, settings):
    """-H g by the two-loop recursion; S, Y are lists of (B, d) rows,
    oldest first, ``count`` (B,) how many of the newest rows each lane
    holds, ``sy`` their (B,) curvatures."""
    m = len(S)
    thr = settings.get("pair_skip_threshold")
    use = []
    for j in range(m):
        held = count > (m - 1 - j)          # row j is among the lane's newest
        use.append(held & (sy[j] > thr) if thr is not None else held)
    q = g.clone()
    alphas = [None] * m
    for j in reversed(range(m)):
        rho = 1.0 / torch.where(use[j], sy[j], torch.ones_like(sy[j]))
        a = torch.where(use[j], rho * _dot(S[j], q), torch.zeros_like(rho))
        q = q - _col(a) * Y[j]
        alphas[j] = a
    r = _col(gamma) * q
    for j in range(m):
        rho = 1.0 / torch.where(use[j], sy[j], torch.ones_like(sy[j]))
        b = torch.where(use[j], rho * _dot(Y[j], r), torch.zeros_like(rho))
        r = r + _col(torch.where(use[j], alphas[j] - b,
                                 torch.zeros_like(b))) * S[j]
    bad = ((count == 0) | ~(gamma > 0) | ~torch.isfinite(gamma)
           | ~torch.isfinite(r).all(dim=-1))
    return torch.where(_col(bad), -g, -r)


def direction(g: torch.Tensor, s_rows: torch.Tensor, y_rows: torch.Tensor,
              held: torch.Tensor, settings: dict) -> torch.Tensor:
    """The direction that a solve takes from its state: g, the ring's rows
    (..., m, d) with the newest pair last, and ``held`` how many of the
    newest rows it holds; -g where it is no descent direction."""
    S, Y = list(s_rows.unbind(-2)), list(y_rows.unbind(-2))
    sy = [_dot(s, y) for s, y in zip(S, Y)]
    d = _direction(g, S, Y, sy, held, sy[-1] / _dot(Y[-1], Y[-1]), settings)
    return torch.where(_col(_dot(g, d) < 0), d, -g)


def _armijo(settings, f_x, f_new, a, gd):
    c1 = settings["c1"]
    if settings["fidelity"] == "reference":
        return (f_x - f_new) >= c1 * a * gd
    return f_new <= f_x + c1 * a * gd


def _ladder(settings, dtype):
    """Every step the backtracking loop can test, in its order, by its own
    repeated multiplication in ``dtype``, and the first value under
    ``backtracking_tol``."""
    shrink = torch.tensor(settings["shrink"], dtype=dtype)
    tol = torch.tensor(settings["backtracking_tol"], dtype=dtype)
    steps = [torch.tensor(settings["initial_step"], dtype=dtype)]
    while True:
        nxt = steps[-1] * shrink
        if nxt < tol:
            return steps, nxt
        steps.append(nxt)


def _backtracking(settings, x, d, f_x, gd, f):
    """(alpha, evaluations) per lane."""
    steps, under = _ladder(settings, x.dtype)
    alpha = torch.full_like(f_x, float("nan"))
    found = torch.zeros_like(f_x, dtype=torch.bool)
    evals = torch.zeros_like(f_x, dtype=torch.int64)
    for a in steps:
        a = a.to(x.device)
        ok = ~found & _armijo(settings, f_x, f(x + a * d), a, gd)
        evals = evals + (~found).to(torch.int64)
        alpha = torch.where(ok, a, alpha)
        found = found | ok
        if bool(found.all()):
            break
    fail = under.item() if settings["fidelity"] == "reference" else 0.0
    return torch.where(found, alpha, torch.full_like(alpha, fail)), evals


def _safe_cubic(fixed, a0, a1, p0, dp0, p1, dp1):
    """A stationary point of the cubic through (a0, p0, dp0), (a1, p1,
    dp1), clamped into the central 80% of the interval, and its midpoint
    where the cubic has no real stationary point or the formula breaks
    down.  ``fixed``: the textbook minimizer (Nocedal and Wright eq. 3.59);
    else the root that the paper's reference code takes."""
    lo_, hi_ = torch.minimum(a0, a1), torch.maximum(a0, a1)
    swap = a0 > a1
    a0, a1 = torch.where(swap, a1, a0), torch.where(swap, a0, a1)
    p0, p1 = torch.where(swap, p1, p0), torch.where(swap, p0, p1)
    dp0, dp1 = torch.where(swap, dp1, dp0), torch.where(swap, dp0, dp1)
    span = a1 - a0
    d1 = dp0 + dp1 - 3.0 * (p1 - p0) / span
    disc = d1 * d1 - dp0 * dp1
    d2 = torch.sqrt(torch.clamp_min(disc, 0.0))
    if fixed:
        denom = dp1 - dp0 + 2.0 * d2
        out = a1 - span * (dp1 + d2 - d1) / denom
    else:
        denom = dp0 - dp1 + 2.0 * d2
        out = a0 + span * (dp0 + d2 - d1) / denom
    bad = (~torch.isfinite(d1) | (disc < 0) | (denom.abs() < 1e-10)
           | ~torch.isfinite(out))
    out = torch.where(bad, 0.5 * (lo_ + hi_), out)
    return torch.minimum(torch.maximum(out, a0 + 0.1 * span),
                         a1 - 0.1 * span)


def _wolfe(settings, x, d, f_x, gd, f, grad):
    """Strong Wolfe by bracketing and zoom: (alpha, evaluations,
    evaluations the bracketing phase made before it stopped) per lane, for
    ``spec_width`` trials a round."""
    c1, c2 = settings["c1"], settings["c2"]
    fixed = settings["fidelity"] == "fixed"
    cap, floor = settings["ls_max_iters"], settings["interp_min"]
    alpha = torch.full_like(f_x, settings["initial_step"])
    lo = torch.zeros_like(f_x)
    hi = torch.full_like(f_x, math.inf)
    f_lo, dphi_lo = f_x.clone(), gd.clone()
    result = alpha.clone()
    done = torch.zeros_like(f_x, dtype=torch.bool)
    evals = torch.zeros_like(f_x, dtype=torch.int64)
    bracket_at = torch.full_like(evals, -1)     # the trial that ends doubling
    for it in range(cap):
        live = ~done
        if not bool(live.any()):
            break
        p = x + _col(alpha) * d
        f_new = f(p)
        dphi = _dot(grad(p), d)
        evals = evals + live.to(torch.int64)
        b1 = (f_new > f_x + c1 * alpha * gd) | ((f_new >= f_lo) & (it > 0))
        acc = ~b1 & (dphi.abs() <= -c2 * gd)
        b2 = ~b1 & ~acc & (dphi >= 0)
        b3 = ~b1 & ~acc & ~b2
        grad_alpha = (f_new - f_x - gd * alpha) / (alpha * alpha)
        a_b1 = _safe_cubic(fixed, lo, alpha, f_lo, dphi_lo, f_new, grad_alpha)
        a_b2 = _safe_cubic(fixed, lo, alpha, f_lo, dphi_lo, f_new, dphi)
        a_b3 = torch.where(torch.isinf(hi), alpha * 2.0,
                           _safe_cubic(fixed, alpha, hi, f_new, dphi, f_new, dphi))
        doubling = torch.isinf(hi)
        stops_doubling = live & doubling & (bracket_at < 0) & \
            (b1 | acc | b2 | (b3 & (2.0 * alpha < floor)))
        bracket_at = torch.where(stops_doubling, torch.full_like(evals, it),
                                 bracket_at)
        nxt = torch.where(b1, a_b1, torch.where(b2, a_b2,
                                                torch.where(b3, a_b3, alpha)))
        floor_hit = ~b1 & ~acc & (nxt < floor)
        new_hi = torch.where(b1 | b2, alpha, hi)
        new_lo = torch.where(b3, alpha, lo)
        new_f_lo = torch.where(b3, f_new, f_lo)
        new_dphi_lo = torch.where(b3, dphi, dphi_lo)
        new_result = torch.where(acc, alpha,
                                 torch.where(floor_hit,
                                             torch.full_like(alpha, floor),
                                             result))
        alpha = torch.where(live, nxt, alpha)
        hi = torch.where(live, new_hi, hi)
        lo = torch.where(live, new_lo, lo)
        f_lo = torch.where(live, new_f_lo, f_lo)
        dphi_lo = torch.where(live, new_dphi_lo, dphi_lo)
        result = torch.where(live, new_result, result)
        done = done | (live & (acc | floor_hit))
    alpha = torch.where(done, result, alpha)
    # A search whose doubling ran to the cap stopped there.
    bracket_at = torch.where(bracket_at < 0, torch.full_like(evals, cap),
                             bracket_at)
    return alpha, evals, bracket_at


def solve(x0: torch.Tensor, settings: dict, iters: int,
          dtype=torch.float64) -> dict:
    """``iters`` iterations from x0 ((d,) or (B, d)) in ``dtype``; tol is 0,
    so a lane stops only where its search fails.  Returns, per lane, what
    the comparison reads of a solve (``cellbench.check``): x, f, g, g_norm,
    k (iterations taken), status, n_fev (evaluations of f, counted as the
    configuration's search counts them: in polynomial mode two per
    iteration, else one per trial and one for the step), alpha (the last
    step), n_pairs (pairs stored), rejects (steps taken whose pair was not
    stored), fallbacks (iterations after the first that stepped along -g),
    failed (0 or 1) and the ring, ``s_rows`` and ``y_rows`` (B, m, d), the
    newest pair last."""
    single = x0.dim() == 1
    x = (x0.unsqueeze(0) if single else x0).to(dtype).clone()
    m = settings["m"]
    width = settings.get("spec_width", 1)
    direct = settings["ls_eval"] == "direct"
    B = x.shape[0]
    f_x, g = rosenbrock_f(x), rosenbrock_grad(x)
    S = [torch.zeros_like(x) for _ in range(m)]
    Y = [torch.zeros_like(x) for _ in range(m)]
    sy = [torch.zeros_like(f_x) for _ in range(m)]
    yy = [torch.ones_like(f_x) for _ in range(m)]
    count = torch.zeros(B, dtype=torch.int64, device=x.device)
    k, n_pairs = torch.zeros_like(count), torch.zeros_like(count)
    rejects, fallbacks = torch.zeros_like(count), torch.zeros_like(count)
    n_fev = torch.ones_like(count)
    alpha_last = torch.zeros_like(f_x)
    running = torch.ones(B, dtype=torch.bool, device=x.device)
    for _ in range(iters):
        if not bool(running.any()):
            break
        gamma = sy[-1] / yy[-1]
        d = _direction(g, S, Y, sy, count, gamma, settings)
        gd = _dot(g, d)
        descent = gd < 0
        fell = (count > 0) & (~descent | (d == -g).all(dim=-1))
        d = torch.where(_col(descent), d, -g)
        gd = torch.where(descent, gd, -_dot(g, g))
        if settings["line_search"] == "backtracking":
            alpha, evals = _backtracking(settings, x, d, f_x, gd,
                                         rosenbrock_f)
        else:
            alpha, evals, bracket = _wolfe(settings, x, d, f_x, gd,
                                           rosenbrock_f, rosenbrock_grad)
            if width > 1:
                # The speculative twin evaluates the doubling ladder
                # ``width`` trials a round, then zooms one at a time.
                rounds = bracket // width + 1
                evals = rounds * width + torch.clamp_min(
                    evals - bracket - 1, 0)
        x_new = x + _col(alpha) * d
        f_new, g_new = rosenbrock_f(x_new), rosenbrock_grad(x_new)
        failed = (~(alpha >= settings["step_fail_tol"])
                  | ~torch.isfinite(f_new)
                  | ~torch.isfinite(_dot(g_new, g_new)))
        step = running & ~failed
        s, y = x_new - x, g_new - g
        s_y, y_y = _dot(s, y), _dot(y, y)
        store = step & (s_y > settings["curvature_threshold"])
        # The ring shifts where a pair is stored: newest last.
        S = [torch.where(_col(store), a, b) for a, b in zip(S[1:] + [s], S)]
        Y = [torch.where(_col(store), a, b) for a, b in zip(Y[1:] + [y], Y)]
        sy = [torch.where(store, a, b) for a, b in zip(sy[1:] + [s_y], sy)]
        yy = [torch.where(store, a, b) for a, b in zip(yy[1:] + [y_y], yy)]
        count = torch.clamp(count + store.to(torch.int64), max=m)
        x = torch.where(_col(step), x_new, x)
        f_x = torch.where(step, f_new, f_x)
        g = torch.where(_col(step), g_new, g)
        live = running.to(torch.int64)
        k = k + live
        n_pairs = n_pairs + store.to(torch.int64)
        rejects = rejects + (step & ~store).to(torch.int64)
        fallbacks = fallbacks + (running & fell).to(torch.int64)
        n_fev = n_fev + live * (1 + evals if direct else 2)
        alpha_last = torch.where(running, alpha, alpha_last)
        running = step
    failed = (k < iters).to(torch.int64)
    status = [MAX_ITERS if f == 0 else LINE_SEARCH_FAILED
              for f in failed.tolist()]
    out = {"x": x, "f": f_x, "g": g, "g_norm": torch.sqrt(_dot(g, g)),
           "k": k, "status": status, "n_fev": n_fev, "alpha": alpha_last,
           "n_pairs": n_pairs, "rejects": rejects, "fallbacks": fallbacks,
           "failed": failed, "s_rows": torch.stack(S, dim=1),
           "y_rows": torch.stack(Y, dim=1)}
    return {n: v[0] for n, v in out.items()} if single else out
