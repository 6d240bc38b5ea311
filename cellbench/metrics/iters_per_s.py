"""Iterations of all the solves that the window completed, over the
window: the solves' own k, summed, over the host clock's seconds from the
first solve's start to the last one's read."""


def read(run):
    return run.window_iterations / run.window_s
