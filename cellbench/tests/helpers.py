"""Small cells for the CPU tests: the benchmark's own cells, cut to sizes a
test run holds."""
from __future__ import annotations

import time

import torch

from cellbench import spec
from cellbench.cell import Run

#: Instance size, batch and pool of the cut cells.
D, BATCH, POOL = 2048, 32, 6


def small_cell(name: str):
    """The cell ``name`` at d = D (a batch of BATCH), a pool of POOL starts
    and its first two solves kept."""
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, d=D,
                       batch=BATCH if cell.config["batch"] else None)
    cell.traffic = dict(cell.traffic, pool=POOL, check_from=2,
                        check_solves=2, iters=min(cell.traffic["iters"], 60))
    return cell


def cpu_run(name: str, seed: int = 2 ** 31 + 7, seconds: float = 1.0):
    """A whole run of the small cell on the CPU but its trace, compared."""
    run = Run(small_cell(name), seed, seconds, torch.device("cpu"),
              time.perf_counter())
    run.setup()
    run.window()
    run.compare()
    return run
