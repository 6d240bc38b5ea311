"""Fixed-iteration throughput of the port on the GPU, with the protocol of
``tpu_lbfgs.bench.harness.bench_tpu``: the same starting points (_x0), tol=0
so that every run does the same iterations, one warm-up run, best of
``repeats`` timed runs per seed, mean over seeds.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import LBFGSConfig
from ..core.solver import init_state, solve_from_state
from ..problems.suite import fused_tail_for, fused_value_and_grad, get_problem

REFERENCE_SEEDS = (42, 365, 12345, 777777, 10000)


@dataclass
class BenchResult:
    name: str
    iters_per_s: float
    wall_s: float
    iterations: int
    final_f: float
    final_g_norm: float
    details: dict


def _x0(d: int, seed: int, dtype, device="cpu") -> torch.Tensor:
    # U(-2, 2), drawn in float64 by numpy and rounded to dtype, exactly as
    # the reference's harness draws it.
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2.0, 2.0, d)
    return torch.from_numpy(base).to(device=device, dtype=dtype)


def bench_gpu(problem: str = "rosenbrock", d: int = 1_000_000,
              iters: int = 200, cfg: Optional[LBFGSConfig] = None,
              dtype=torch.float32, seeds=REFERENCE_SEEDS[:1],
              repeats: int = 3) -> BenchResult:
    """Fixed-iteration throughput of the solver on the current CUDA
    device, fenced by ``torch.cuda.synchronize()``.  Raises when no CUDA
    device is present: a CPU number is not a GPU measurement."""
    if not torch.cuda.is_available():
        raise RuntimeError("bench_gpu needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    cfg = cfg or LBFGSConfig(line_search="backtracking",
                             direction="compact_incremental",
                             ls_eval="polynomial", use_pallas=True)
    cfg = cfg.replace(max_iters=iters, tol=0.0)   # tol=0: never stop early
    p = get_problem(problem)
    vg = fused_value_and_grad(problem, use_pallas=cfg.use_pallas)
    fused_tail = fused_tail_for(problem, use_pallas=cfg.use_pallas)

    def run(x0):
        state = init_state(vg, x0, cfg.m, cfg.history_dtype)
        return solve_from_state(cfg, p.f, vg, state, p.dir_poly, fused_tail)

    per_seed, all_walls, warmup_s, out = [], [], None, None
    for seed in seeds:
        x0 = _x0(d, seed, dtype, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(x0)
        torch.cuda.synchronize()
        if warmup_s is None:
            warmup_s = time.perf_counter() - t0
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            out = run(x0)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        all_walls.extend(walls)
        per_seed.append(min(walls))
    wall = float(np.mean(per_seed))
    return BenchResult(
        name=(f"gpu/{problem}/d={d}/{cfg.line_search}/{cfg.direction}/"
              f"{str(dtype).removeprefix('torch.')}"),
        iters_per_s=iters / wall, wall_s=wall, iterations=int(out.k),
        final_f=float(out.f), final_g_norm=float(out.g_norm),
        details={"per_seed_s": per_seed, "repeat_walls_s": all_walls,
                 "warmup_s": warmup_s, "n_fev": int(out.n_fev),
                 "n_gev": int(out.n_gev),
                 "device": torch.cuda.get_device_name(device)})
