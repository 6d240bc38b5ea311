"""Device kernels per lockstep iteration in the profiled slice, the
solves' starts and reads included (copies and fills are not kernels)."""
from cellbench.roofline import kernels_per_step


def read(run):
    return kernels_per_step(run)
