"""Aten operations per iteration of the port's solver paths, on the CPU.

The solves are bound by the host's launches, so an operation added to
``iterate`` costs time on every path that runs it.  This counts them with
``torch.profiler`` at a small size, where the count is the same as at full
size (it does not depend on d), so two trees can be compared without a GPU:

    python -m tpu_lbfgs_torch.bench.op_count

prints one line per path: operations per iteration and the sum of f after
the counted iterations (two trees that agree on both run the same
arithmetic).  It measures no time.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from ..config import REFERENCE_PARALLEL, LBFGSConfig
from ..core.solver import init_state, iterate, make_value_and_grad
from ..problems.suite import fused_tail_for, fused_value_and_grad, get_problem

BENCH = LBFGSConfig(line_search="backtracking",
                    direction="compact_incremental", m=10, use_pallas=True,
                    ls_eval="polynomial")


def paths() -> dict:
    """name -> (cfg, batched, fused); the fused paths take the Rosenbrock
    kernels' wrappers, the others f and grad."""
    return {
        "bench.py single": (BENCH, False, True),
        "bench.py batch": (BENCH.replace(use_pallas=False, fidelity="fixed",
                                         pair_skip_threshold=1e-10),
                           True, False),
        "direct backtracking": (REFERENCE_PARALLEL.replace(
            direction="compact_incremental", ls_eval="direct",
            use_pallas=True, alpha_rescue_floor=None), False, True),
        "general two_loop": (BENCH.replace(direction="two_loop"), False,
                             False),
        "general compact": (BENCH.replace(direction="compact"), False, False),
        "general compact_incremental": (BENCH, False, False),
    }


def count(cfg: LBFGSConfig, batched: bool, fused: bool, d: int = 4096,
          warmup: int = 15, iters: int = 10) -> tuple[float, float]:
    """(aten operations per iteration, sum of f afterwards) on the CPU."""
    p = get_problem("rosenbrock")
    x0 = torch.from_numpy(np.random.default_rng(42).uniform(
        -2.0, 2.0, d)).float()
    if batched:
        x0 = x0.reshape(8, -1)
    vg = fused_value_and_grad("rosenbrock") if fused \
        else make_value_and_grad(p.f, p.grad)
    tail = fused_tail_for("rosenbrock") if fused else None
    state = init_state(vg, x0, cfg.m)
    for _ in range(warmup):
        state = iterate(cfg, p.f, vg, state, p.dir_poly, tail)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            state = iterate(cfg, p.f, vg, state, p.dir_poly, tail)
    ops = sum(e.count for e in prof.key_averages())
    return ops / iters, state.f.sum().item()


def main() -> None:
    torch.set_num_threads(1)
    for name, args in paths().items():
        ops, f = count(*args)
        print(f"{name}: {ops:.1f} aten ops/iteration, sum f {f!r}")


if __name__ == "__main__":
    main()
