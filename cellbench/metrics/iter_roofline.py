"""The window's iterations/s (lockstep iterations for a batch) times the
bytes one iteration needs by the frozen traffic model
(``cellbench/traffic_model.py``, all lanes), over the card's memory rate
(``cellbench/peaks.py``), in %.  Bound: bytes; the card's power limit
stands in the result line."""
from cellbench.roofline import iteration_pct


def read(run):
    return iteration_pct(run)
