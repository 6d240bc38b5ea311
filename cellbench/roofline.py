"""The arithmetic the per-layer readers share: a kernel's share of its
roofline and the iteration's share of the card's memory rate, from the
run's profiled slice and counters.  Each reader brings its own bytes and
operations (``metrics/*.py``)."""
from __future__ import annotations

from . import traffic_model
from .peaks import peaks


def _peaks(run) -> dict:
    import torch
    return peaks(torch.cuda.get_device_name(run.device))


def kernel_pct(run, kernel: str, n_bytes: float, n_ops: float = 0.0):
    """100 x the least time ``n_bytes`` and ``n_ops`` take at the card's
    peaks, over the mean device time of a call of ``kernel`` in the slice;
    None where the slice holds no call."""
    if run.slice is None:
        return None
    calls = run.slice.calls(kernel)
    if not calls:
        return None
    peak = _peaks(run)
    bound = max(n_bytes / peak["hbm_bytes_per_s"],
                n_ops / peak["f32_ops_per_s"])
    return 100.0 * bound * len(calls) / sum(calls)


def idle_pct(run):
    """100 x the share of the slice in which no device operation ran."""
    if run.slice is None:
        return None
    return 100.0 * (1.0 - run.slice.busy_s / run.slice.window_s)


def kernels_per_step(run):
    """Device kernels in the slice per lockstep iteration of it."""
    if run.slice is None or not run.slice_steps:
        return None
    return len(run.slice.kernels) / run.slice_steps


def iteration_pct(run):
    """100 x the window's lockstep iterations/s times the frozen traffic
    model's bytes per iteration, over the card's memory rate."""
    prog = run.program
    steps = run.window_steps
    if not steps:
        return None
    trials = run.fevs / run.iterations - 1.0
    per_iter = traffic_model.bytes_per_iteration(
        prog.settings, prog.d, prog.itemsize, prog.batch or 1, trials)
    return (100.0 * steps / run.window_s * per_iter
            / _peaks(run)["hbm_bytes_per_s"])
