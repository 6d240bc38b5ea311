"""A run's comparison on the CPU, at a size a test run holds: sound runs
come out correct; the control, and runs whose timed path is broken
underneath, do not."""
import pytest
import torch

from cellbench import check, control
from cellbench.tests.helpers import cpu_run, small_cell

CELLS = ("genrose-d2e20.main", "genrose-d2e20.direct-wolfe",
         "genrose-b4096.lockstep")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    run = cpu_run(name)
    correct, shown = check.verdict(run.numbers, run.cell.limits)
    assert correct, shown
    assert set(shown) == set(run.cell.limits)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    for seed in (11, 12, 13):
        got = control.numbers(cell, seed, torch.device("cpu"))
        assert not check.verdict(got, cell.limits)[0], got


def _stuck(real):
    """A step that returns its state unchanged but for its count."""
    def step(cfg, f, vg, state, *args, lanes=None, **kwargs):
        more = 1 if lanes is None else lanes.to(state.k.dtype)
        return state.replace(k=state.k + more)
    return step


def _half(real):
    """A step that leaves the second half of the batch out."""
    def step(cfg, f, vg, state, *args, lanes=None, **kwargs):
        n = state.x.shape[0]
        keep = torch.arange(n, device=state.x.device) < n // 2
        lanes = keep if lanes is None else lanes & keep
        return real(cfg, f, vg, state, *args, lanes=lanes, **kwargs)
    return step


def _altered(real):
    """A solve whose answer is altered where it is produced."""
    def solve(*args, **kwargs):
        out = real(*args, **kwargs)
        out.x[..., 0] += 1.0
        return out
    return solve


FAULTS = [(name, "core.solver", "iterate", _stuck) for name in CELLS]
FAULTS += [("genrose-b4096.lockstep", "core.solver", "iterate", _half)]
FAULTS += [(name, "", "solve_bounded" if "b4096" in name
            else "solve_from_state", _altered) for name in CELLS]


@pytest.mark.parametrize("name, module, attr, fault", FAULTS)
def test_fault_is_not_correct(monkeypatch, name, module, attr, fault):
    import importlib

    mod = importlib.import_module(
        "tpu_lbfgs_torch" + (f".{module}" if module else ""))
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    run = cpu_run(name)
    correct, shown = check.verdict(run.numbers, run.cell.limits)
    assert not correct, shown
