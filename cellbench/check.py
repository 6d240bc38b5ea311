"""The comparison that decides whether a run is ``correct``.

A timed solve hands back its final state: x, f, g, ||g||, k, the status,
the counts, the last step and the ring of its last m pairs.  The plain
reference (``reference/lbfgs.py``) judges it, in float64, at the
program's own points, since two float32 solves of the chained Rosenbrock
function part after a few dozen iterations (a line search that takes 1
where the other takes 0.5) and their end points then differ by percents:

- ``f_at_x``: |f - F(x)| / |F(x)|, F the reference's objective: the value
  the program returns is the objective at the point it returns;
- ``g_at_x``: ||g - grad F(x)|| / ||grad F(x)||, and the same of ||g||;
- ``ring_gap``: the ring read back: x_j = x - (s_0 + ... + s_{j-1}) and
  g_j = g - (y_0 + ... + y_{j-1}) over the newest pairs, and the largest
  ||g_j - grad F(x_j)|| / ||grad F(x_j)||: the last min(k, m) steps were
  taken along s with the true gradients.  A solve that rejected no pair
  must hold a pair for each of those steps; one that holds fewer reads 1;
- ``secant_gap``: each of those steps along the L-BFGS direction.  The
  direction of a step, d = -H g, satisfies H y = s for the newest pair
  (s, y) before it, so d.y = -g.s, with d = s_step / alpha; it reads
  |s_step.y / alpha + g.s| / (|s_step.y / alpha| + |g.s|), alpha the
  state's last step for the newest step, and the nearest of the
  backtracking ladder's steps for the others where the search is
  backtracking (elsewhere only the newest step is read), where g.s is
  not cancelled to rounding (``SECANT_COND``);
- ``armijo_gap``: each of those steps met the sufficient-decrease rule
  of the cell's search, read from the reference's f at both ends and its
  gradient at the start: F(x_j + s) <= F(x_j) + c1 grad F(x_j).s (the
  sign of the c1 term flipped under fidelity "reference" on the ladder,
  the paper's rule), as the excess over the rule divided by |F(x_j)|;
  where the search is backtracking, the newest step (whose alpha the
  state holds) was also the ladder's first that passes: where that alpha
  is on the ladder below its first step, the step before it, x_j + s /
  shrink, reads as its excess the margin by which it would have passed;
- ``curvature_gap`` (a strong Wolfe search): each of those steps met
  |grad F(x_j + s).s| <= c2 |grad F(x_j).s|, as the excess over
  c2 |grad F(x_j).s| divided by |grad F(x_j).s|;
- ``short``: solves (lanes) whose status says they ran their budget and
  whose k is not that budget, or that did not end as the budget says:
  the configuration states tol = 0, so a solve runs its budget unless its
  search fails.

Beside those, three comparisons with the reference's own steps:

- ``direction_gap`` (a cell of single instances): from each kept solve's
  final state, the timed entry and its kept runner, through its replayed
  graphs, take one more step; its direction, s / alpha of the pair it
  stores, against the direction the reference takes from that state (its
  g and ring, in float64), ||d - d_ref|| / ||d_ref||.  The reference
  follows the program from the program's own state here, since two
  float32 solves part after a few dozen iterations, where a trial lies
  within rounding of the Armijo rule on one side and not on the other;
- ``start_gap`` (a cell of single instances): the stage before the ring
  first wraps, ``init_state`` and the first iterations of sampled starts
  by the timed entry (a budget that short captures no graphs), ||x -
  x_ref|| / ||x_ref||, the reference in the configuration's dtype;
- ``f_gap_median`` (a batch): the median over the lanes of |f - f_ref| /
  |f_ref| after the whole budget, the reference in float64.

A solve that rejected a pair is not read by the ring or the steps'
acceptance, one that fell back to -g not by the secant (where in its run
that happened cannot be told from its state).  Every number is the largest over what was read; a
number that could not be computed (NaN) fails.
"""
from __future__ import annotations

import math

import torch

from .reference.lbfgs import direction, rosenbrock_f, rosenbrock_grad

#: The secant relation d.y = -g.s of a step is read where g.s is at least
#: this share of |g| |s|: where it is smaller, both sides are dot products
#: cancelled to a few float32 roundings of the vectors, and the relation
#: says nothing beyond them.
SECANT_COND = 1e-2


def _rel(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    tiny = torch.finfo(torch.float64).tiny
    return num / torch.clamp_min(den.abs(), tiny)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v, dim=-1)


def _dot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.sum(u * v, dim=-1)


def ladder(settings: dict) -> list:
    """The steps the backtracking search can take, in float64: its ladder
    and, under fidelity "reference", the step under ``backtracking_tol``
    that it takes when no trial passes."""
    steps = [settings["initial_step"]]
    while steps[-1] * settings["shrink"] >= settings["backtracking_tol"]:
        steps.append(steps[-1] * settings["shrink"])
    if settings["fidelity"] == "reference":
        steps.append(steps[-1] * settings["shrink"])
    return steps


def end_state(res: dict, settings: dict, budget: int) -> dict:
    """Per lane of the solve result ``res`` (the reference's format: x, f,
    g, g_norm, k, status, alpha, n_pairs, rejects, fallbacks, failed,
    s_rows and y_rows with the newest pair last; a lane axis first, or
    none for one instance): ``f_at_x``, ``g_at_x``, ``ring_gap``,
    ``secant_gap``, ``armijo_gap``, ``curvature_gap`` (NaN where not read)
    and ``short`` (bool)."""
    one = res["x"].dim() == 1

    def lanes(v):
        v = v.double() if v.is_floating_point() else v.long()
        return v.unsqueeze(0) if one else v

    x, f, g, g_norm = (lanes(res[n]) for n in ("x", "f", "g", "g_norm"))
    k, n_pairs, rejects, fallbacks, failed = (
        lanes(res[n]) for n in ("k", "n_pairs", "rejects", "fallbacks",
                                "failed"))
    alpha = lanes(res["alpha"])
    S, Y = lanes(res["s_rows"]), lanes(res["y_rows"])
    status = [res["status"]] if one else list(res["status"])
    m = S.shape[-2]

    F, G = rosenbrock_f(x), rosenbrock_grad(x)
    g_ref = _norm(G)
    c1, c2 = settings["c1"], settings["c2"]
    backtracking = settings["line_search"].startswith("backtracking")
    wolfe = "wolfe" in settings["line_search"]
    sign = -1.0 if backtracking and settings["fidelity"] == "reference" \
        else 1.0
    f_at_x = _rel((f - F).abs(), F)
    g_at_x = torch.maximum(_rel(_norm(g - G), g_ref),
                           _rel((g_norm - g_ref).abs(), g_ref))

    ran = (torch.tensor([s == "max_iters" for s in status],
                        device=k.device) & (failed == 0))
    short = (ran & (k != budget)) | (~ran & (failed == 0))

    steps = k - failed
    need = torch.clamp(steps, max=m)
    held = torch.clamp(n_pairs, max=m)
    read = rejects == 0
    ring = torch.where(read & (held < need), 1.0, 0.0).to(x.dtype)
    thr = settings.get("pair_skip_threshold")
    cands = torch.tensor(ladder(settings), dtype=x.dtype, device=x.device) \
        if settings["line_search"].startswith("backtracking") else None
    secant = torch.full_like(f, math.nan)
    armijo = torch.full_like(f, math.nan)
    curvature = torch.full_like(f, math.nan)
    xj, gj = x.clone(), g.clone()
    F_end, G_end = F, G          # the reference at the end of step j
    for j in range(m):
        s_j, y_j = S[:, m - 1 - j], Y[:, m - 1 - j]
        live = read & (j < need) & (j < held)
        # Step j (newest first) started at x_j - s_j, where the gradient
        # was g_j - y_j; the pair before it is j + 1.
        xj, gj = xj - s_j, gj - y_j
        Fj, Gj = rosenbrock_f(xj), rosenbrock_grad(xj)
        gap = _rel(_norm(gj - Gj), _norm(Gj))
        ring = torch.where(live, torch.maximum(ring, gap), ring)
        gs = _dot(Gj, s_j)
        excess = _rel(torch.clamp_min(F_end - Fj - sign * c1 * gs, 0.0), Fj)
        if backtracking and j == 0:
            # The step before the newest one on the ladder failed the rule.
            prev = ((alpha < settings["initial_step"] * (1.0 - 1e-6))
                    & (alpha >= settings["backtracking_tol"]))
            before = rosenbrock_f(xj + s_j / settings["shrink"])
            margin = Fj + sign * c1 * gs / settings["shrink"] - before
            excess = torch.where(prev & (failed == 0), torch.maximum(
                excess, _rel(torch.clamp_min(margin, 0.0), Fj)), excess)
        armijo = torch.where(live, torch.fmax(armijo, excess), armijo)
        if wolfe:
            bend = _rel(torch.clamp_min(
                _dot(G_end, s_j).abs() - c2 * gs.abs(), 0.0), gs)
            curvature = torch.where(live, torch.fmax(curvature, bend),
                                    curvature)
        F_end, G_end = Fj, Gj
        if j + 1 >= m:
            break
        s_p, y_p = S[:, m - 2 - j], Y[:, m - 2 - j]
        a, b = _dot(s_j, y_p), _dot(gj, s_p)
        on = (live & (fallbacks == 0) & (j + 1 < need) & (j + 1 < held)
              & (b.abs() >= SECANT_COND * _norm(gj) * _norm(s_p)))
        if thr is not None:
            on = on & (_dot(s_p, y_p) > 10.0 * thr)
        if j == 0:
            # The newest step's alpha is the state's, unless its lane's
            # last search failed: it then took its last step on the ladder.
            r = _secant(a, b, alpha.unsqueeze(-1))
            if cands is None:
                on_j = on & (failed == 0)
            else:
                r = torch.where(failed == 0, r,
                                _secant(a, b, cands.expand(len(f), -1)))
                on_j = on
        elif cands is not None:
            r, on_j = _secant(a, b, cands.expand(len(f), -1)), on
        else:
            continue
        secant = torch.where(on_j, torch.fmax(secant, r), secant)
    return {"f_at_x": f_at_x, "g_at_x": g_at_x, "ring_gap": ring,
            "secant_gap": secant, "armijo_gap": armijo,
            "curvature_gap": curvature, "short": short}


def _secant(a: torch.Tensor, b: torch.Tensor,
            alphas: torch.Tensor) -> torch.Tensor:
    """min over ``alphas`` (lanes, n) of |a / alpha + b| / (|a / alpha| +
    |b|)."""
    q = a.unsqueeze(-1) / alphas
    bb = b.unsqueeze(-1)
    r = (q + bb).abs() / torch.clamp_min(q.abs() + bb.abs(),
                                         torch.finfo(q.dtype).tiny)
    return r.min(dim=-1).values


def direction_gap(d: torch.Tensor, res: dict, settings: dict) -> float:
    """||d - d_ref|| / ||d_ref||: ``d`` the direction that the program took
    from the final state of the solve ``res`` (the reference's format), and
    d_ref the reference's direction from that state in float64."""
    held = torch.clamp(res["n_pairs"].long(), max=res["s_rows"].shape[-2])
    d_ref = direction(res["g"].double(), res["s_rows"].double(),
                      res["y_rows"].double(), held, settings)
    return x_gap(d, d_ref)


def x_gap(x: torch.Tensor, x_ref: torch.Tensor) -> float:
    """||x - x_ref|| / ||x_ref|| over the whole vector (or batch)."""
    x, x_ref = x.double(), x_ref.double()
    return float(torch.linalg.vector_norm(x - x_ref)
                 / torch.linalg.vector_norm(x_ref))


def f_gap_median(f: torch.Tensor, f_ref: torch.Tensor) -> float:
    """The median over the lanes of |f - f_ref| / |f_ref|."""
    gap = _rel((f.double() - f_ref.double()).abs(), f_ref.double())
    return float(torch.quantile(gap, 0.5))


def largest(values) -> float:
    """The largest of ``values`` (tensors or numbers), NaN-ignoring; 0
    where nothing was read."""
    flat = [float(v) for t in values
            for v in (t.flatten().tolist() if torch.is_tensor(t) else [t])]
    flat = [v for v in flat if not math.isnan(v)]
    return max(flat) if flat else 0.0


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a NaN or a missing number fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name, math.nan)
        out[name] = {"value": value, "limit": limit}
        ok = ok and not math.isnan(value) and value <= limit
    return ok, out
