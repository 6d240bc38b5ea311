"""The plain reference against the program at a small size on the CPU, and
the reference alone: it loads nothing of the program, and the check reads
its own solves as sound."""
import subprocess
import sys

import pytest
import torch

from cellbench import check, spec
from cellbench.cell import NUMBERS, Program, draw_pool
from cellbench.reference import lbfgs as reference

ITERS = 8


@pytest.mark.parametrize("name", ["genrose-d2e20.main",
                                  "genrose-d2e20.direct-wolfe",
                                  "genrose-b4096.lockstep"])
def test_reference_follows_the_program(name):
    """The first iterations of the program and of the reference in the
    program's float32 agree: the same steps, the same evaluations, x to
    float32 rounding grown over a few iterations."""
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, d=4096,
                       batch=16 if cell.config["batch"] else None)
    prog = Program(cell, torch.device("cpu"))
    shape = ((16,) if prog.batch else ()) + (4096,)
    x0 = draw_pool(5, 1, shape, cell.traffic["box"], torch.float32,
                   "cpu")[0]
    got = prog.solve(x0, ITERS)
    ref = reference.solve(x0, prog.settings, ITERS, torch.float32)
    assert torch.equal(got.k.long(), ref["k"])
    assert torch.equal(got.n_fev.long(), ref["n_fev"])
    assert torch.equal(got.n_pairs.long(), ref["n_pairs"])
    assert torch.allclose(got.alpha, ref["alpha"].float(), rtol=1e-5)
    assert check.x_gap(got.x, ref["x"]) < 1e-5


@pytest.mark.parametrize("name", ["genrose-d2e20.main",
                                  "genrose-d2e20.direct-wolfe",
                                  "genrose-b4096.lockstep"])
def test_check_reads_the_reference_as_sound(name):
    cell = spec.load_cell(name)
    settings = cell.settings()
    shape = (8, 512) if cell.config["batch"] else (512,)
    x0 = draw_pool(9, 1, shape, cell.traffic["box"], torch.float64, "cpu")[0]
    res = reference.solve(x0, settings, 30, torch.float64)
    per = check.end_state(res, settings, 30)
    for number in NUMBERS:
        assert check.largest([per[number]]) < 1e-9, number
    assert not per["short"].any()


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, cellbench.reference.lbfgs, cellbench.check;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=spec.ROOT).stdout
    top = eval(out)
    assert not {"tpu_lbfgs_torch", "tpu_lbfgs", "jax", "jaxlib"} & set(top)


@pytest.mark.parametrize("name", ["genrose-d2e20.main",
                                  "genrose-d2e20.direct-wolfe"])
def test_direction_gap_reads_the_reference_as_sound(name):
    """The direction of the reference's next step, against the direction
    the check works out from the state before it, in float64."""
    cell = spec.load_cell(name)
    settings = cell.settings()
    x0 = draw_pool(4, 1, (512,), cell.traffic["box"], torch.float64,
                   "cpu")[0]
    res = reference.solve(x0, settings, 30, torch.float64)
    more = reference.solve(x0, settings, 31, torch.float64)
    assert int(more["n_pairs"]) == int(res["n_pairs"]) + 1
    d = more["s_rows"][-1] / more["alpha"]
    assert check.direction_gap(d, res, settings) < 1e-9
    assert check.direction_gap(-res["g"], res, settings) > 0.1
