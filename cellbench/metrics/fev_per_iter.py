"""Evaluations of the objective per iteration, the solves' own count: the
states' n_fev over their k, summed over the solves (one evaluation at
each start, one a step, and the line search's trials).  Moves
``iters_per_s``."""


def read(run):
    if not run.iterations:
        return None
    return run.fevs / run.iterations
