"""Fixed-iteration throughput of the port on the GPU, with the protocols of
``tpu_lbfgs.bench.harness``: ``bench_gpu`` as ``bench_tpu`` (the same
starting points (_x0), tol=0 so that every run does the same iterations,
one warm-up run, best of ``repeats`` timed runs per seed, mean over seeds),
and ``bench_batch`` as its namesake (a batch of instances in bounded
lockstep, instance-iterations/s).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import LBFGSConfig
from ..core.solver import (
    init_state,
    make_value_and_grad,
    resolve_history_dtype,
    solve_bounded,
    solve_from_state,
)
from ..problems.suite import (
    fused_tail_for,
    fused_value_and_grad,
    get_problem,
    multi_phi_dphi_for,
    multi_phi_for,
    resolve_use_pallas,
)

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


def _cuda_device(what: str) -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device")
    return torch.device("cuda", torch.cuda.current_device())


def main_path_cfg() -> LBFGSConfig:
    """The configuration of the port's main path (the one ``bench.py``
    times in the reference): Armijo backtracking on the directional
    polynomial, the incremental compact direction, the fused kernels."""
    return LBFGSConfig(line_search="backtracking",
                       direction="compact_incremental",
                       ls_eval="polynomial", use_pallas=True)


def solve_callables(problem: str, d: int, cfg: LBFGSConfig, dtype,
                    with_matvec=False):
    """(vg, dir_poly, fused_tail, phi_batch, phi_dphi_batch) as
    ``bench_gpu`` hands them to the solver, the reference's ``bench_tpu``
    rules: under ``cfg.use_pallas`` the problem's fused value-and-gradient,
    its fused tail (built for ``with_matvec``, ``cfg.accurate_dots``,
    ``cfg.m``, ``d`` and the resolved ``cfg.history_dtype``) and, for a
    speculative search in direct mode, its K-trial evaluator; otherwise the
    problem's plain f and gradient and no tail.  ``dir_poly`` under
    ``cfg.ls_eval="polynomial"`` only.  For another ``dtype`` than float32
    the fused callables are built from their plain versions, with a
    warning (``problems.suite.resolve_use_pallas``)."""
    p = get_problem(problem)
    fused_tail = phi_batch = phi_dphi_batch = None
    if cfg.use_pallas:
        kernels = resolve_use_pallas(True, dtype, "bench_gpu")
        vg = fused_value_and_grad(problem, use_pallas=kernels)
        fused_tail = fused_tail_for(
            problem, with_matvec=with_matvec, use_pallas=kernels, m=cfg.m, d=d,
            history_dtype=resolve_history_dtype(cfg.history_dtype, cfg.m, d,
                                                dtype),
            accurate_dots=cfg.accurate_dots)
        if cfg.ls_eval == "direct":
            if cfg.line_search == "backtracking_speculative":
                phi_batch = multi_phi_for(problem, use_pallas=kernels)
            if cfg.line_search in ("wolfe_interpolation_speculative",
                                   "backtracking_wolfe_speculative"):
                phi_dphi_batch = multi_phi_dphi_for(problem,
                                                    use_pallas=kernels)
    else:
        vg = make_value_and_grad(p.f, p.grad)
    dir_poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
    return vg, dir_poly, fused_tail, phi_batch, phi_dphi_batch


def bench_gpu(problem: str = "rosenbrock", d: int = 1_000_000,
              iters: int = 200, cfg: Optional[LBFGSConfig] = None,
              dtype=torch.float32, seeds=REFERENCE_SEEDS[:1],
              repeats: int = 3, with_matvec=False) -> BenchResult:
    """Fixed-iteration throughput of the solver on the current CUDA
    device, fenced by ``torch.cuda.synchronize()``, with ``bench_tpu``'s
    signature and default configuration (backtracking, ``compact``, direct
    evaluation, no kernels; ``main_path_cfg()`` is the main path's).
    Raises when no CUDA device is present: a CPU number is not a GPU
    measurement."""
    device = _cuda_device("bench_gpu")
    cfg = cfg or LBFGSConfig(line_search="backtracking", direction="compact")
    cfg = cfg.replace(max_iters=iters, tol=0.0)   # tol=0: never stop early
    p = get_problem(problem)
    vg, *callables = solve_callables(problem, d, cfg, dtype, with_matvec)

    def run(x0):
        state = init_state(vg, x0, cfg.m, cfg.history_dtype)
        return solve_from_state(cfg, p.f, vg, state, *callables)

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


def bench_batch(problem: str = "rosenbrock", batch: int = 4096,
                d: int = 1024, iters: int = 200,
                cfg: Optional[LBFGSConfig] = None, dtype=torch.float32,
                seed: int = 42, repeats: int = 3) -> BenchResult:
    """Thousands of independent instances in bounded lockstep on the
    current CUDA device (``solve_bounded`` over a (batch, d) state, as the
    reference's jitted vmap of it).  Reports instance-iterations/s = batch *
    iters / wall, best of ``repeats`` runs after one warm-up, each fenced by
    ``torch.cuda.synchronize()``.  Raises when no CUDA device is present."""
    device = _cuda_device("bench_batch")
    # fidelity="fixed" (a search that never satisfies Armijo fails instead
    # of stepping untested) and the pair skip keep every float32 lane
    # finite, as in the reference's bench_batch.
    cfg = cfg or LBFGSConfig(line_search="backtracking",
                             direction="compact_incremental",
                             ls_eval="polynomial", fidelity="fixed",
                             pair_skip_threshold=1e-10)
    cfg = cfg.replace(max_iters=iters, tol=0.0)
    p = get_problem(problem)
    vg = make_value_and_grad(p.f, p.grad)
    dir_poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
    # The reference's draw: U(-2, 2) of shape (batch, d) in float64, rounded
    # to dtype.
    rng = np.random.default_rng(seed)
    x0s = torch.from_numpy(rng.uniform(-2.0, 2.0, (batch, d))).to(
        device=device, dtype=dtype)

    def run():
        state = init_state(vg, x0s, cfg.m, cfg.history_dtype)
        return solve_bounded(cfg, p.f, vg, state, dir_poly)

    out = run()
    torch.cuda.synchronize()
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    return BenchResult(
        name=f"gpu-batch/{problem}/B={batch}/d={d}/{cfg.line_search}",
        iters_per_s=batch * iters / best, wall_s=best, iterations=iters,
        final_f=float(out.f.mean()), final_g_norm=float(out.g_norm.max()),
        details={"batch": batch, "per_instance_iters_per_s": iters / best,
                 "repeat_walls_s": walls,
                 "status_counts": torch.bincount(out.status.long(), minlength=4)
                 .tolist(),
                 "device": torch.cuda.get_device_name(device)})
