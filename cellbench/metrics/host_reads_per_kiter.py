"""The host loop's reads of its flags per 1,000 iterations of the window
(``blocks.stats["host_reads"]``): one per block of the replayed solve and
one at its start.  Moves ``iters_per_s``."""


def read(run):
    if not run.window_iterations:
        return None
    return 1000.0 * run.host_reads / run.window_iterations
