"""Instance-iterations of all the lockstep runs that the window completed,
over the window: runs x lanes x the budget each run steps, over the host
clock's seconds from the first run's start to the last one's read."""


def read(run):
    prog = run.program
    return run.window_solves * prog.batch * prog.budget / run.window_s
