"""The share of the profiled slice in which no operation ran on the
card, in %."""
from cellbench.roofline import idle_pct


def read(run):
    return idle_pct(run)
