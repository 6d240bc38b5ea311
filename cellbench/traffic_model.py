"""The frozen traffic model of one L-BFGS iteration: the passes over
d-sized vectors that the algorithm of a configuration needs, as bytes.

A copy of the program's ``utils/roofline.py::traffic_model`` (the JAX
package's count, pass for pass), kept here so that a change to the program
cannot move the yardstick.  It counts what the configuration's algorithm
needs, not what the program's code chooses: the history products S y, Y y
are one vector pass of their own (the program's ``with_matvec`` folds them
into the tail), and a history ring never stays in a cache.  1 pass = d
elements of the iterate's dtype read or written once:

direction "two_loop": 4 m history + 4 m vector passes, + 2.
direction "compact": S'Y, Y'Y, S'g, Y'g (5 m history + 1), then the
    combine gamma g + v S - gamma u Y (2 m history + 2).
direction "compact_incremental": S y, Y y (2 m history + 1) and the
    combine (2 m history + 2).
line search "polynomial": one (x, d) pass for the coefficients; "direct":
    (x, d) and the objective per trial evaluated, a gradient pass per
    trial of the sequential Wolfe searches, the speculative ladder's
    trials sharing one (x, d) stream per round where it is
    ``backtracking_speculative``.
tail: fused, read x, d, g, write x_new, g_new and the two rows; otherwise
    x_new, the value and gradient, and the tail's sums.  The ring's row
    write: 4 row passes.
"""
from __future__ import annotations


def passes_per_iteration(settings: dict, trials_per_iteration: float,
                         obj_passes: float = 1.0) -> float:
    """Vector passes one iteration needs under ``settings`` (the solver
    settings of a cell: ``m``, ``direction``, ``ls_eval``,
    ``line_search``, ``use_pallas``), with ``trials_per_iteration`` line
    search evaluations an iteration (n_fev / k - 1 of the solves run)."""
    m = settings["m"]
    if settings["direction"] == "two_loop":
        p_dir = 4.0 * m + 4.0 * m + 2.0
    elif settings["direction"] == "compact_incremental":
        p_dir = 2.0 * m + 1.0 + 2.0 * m + 2.0
    else:
        p_dir = 5.0 * m + 1.0 + 2.0 * m + 2.0

    if settings["ls_eval"] == "polynomial":
        p_ls = 2.0
    else:
        per_trial = 2.0 + obj_passes
        if settings["line_search"] == "backtracking_speculative":
            per_trial = (2.0 + obj_passes) / max(trials_per_iteration, 1.0)
        elif settings["line_search"] in ("backtracking_wolfe",
                                         "backtracking_wolfe_bisect",
                                         "wolfe_interpolation"):
            per_trial += 1.0
        p_ls = per_trial * trials_per_iteration
        if settings["direction"] == "two_loop":
            p_ls += 2.0

    if settings["use_pallas"]:
        p_tail, p_vg = 3.0 + 2.0 + 2.0, 0.0
    else:
        p_tail, p_vg = 3.0 + 7.0, 2.0 + obj_passes
    return p_dir + p_ls + p_tail + 4.0 + p_vg


def bytes_per_iteration(settings: dict, d: int, itemsize: int, lanes: int,
                        trials_per_iteration: float) -> float:
    """Device-memory bytes one lockstep iteration of ``lanes`` instances
    of size ``d`` needs."""
    return (passes_per_iteration(settings, trials_per_iteration)
            * d * itemsize * lanes)
