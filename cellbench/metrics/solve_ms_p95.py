"""The 95th percentile, nearest rank, of the walls of every solve of the
window, in ms: from before its ``init_state`` to its last read on the
host.  At least 200 solves put 10 beyond it (``stats.least_samples``);
the run says on standard error how many it had."""
from cellbench import stats


def read(run):
    walls = run.walls[:run.window_solves]
    if not walls:
        return None
    return stats.percentile(walls, 95) * 1e3
