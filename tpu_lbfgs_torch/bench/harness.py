"""Throughput and time to tolerance of the port on the GPU, with the
protocols of ``tpu_lbfgs.bench.harness``: ``bench_gpu`` as ``bench_tpu``
(the same starting points (_x0), tol=0 so that every run does the same
iterations, one warm-up run, best of ``repeats`` timed runs per seed, mean
over seeds), ``bench_batch`` as its namesake (a batch of instances in
bounded lockstep, instance-iterations/s), and ``time_to_tolerance`` /
``time_to_tolerance_refined`` as theirs (the wall time of a solve to a
gradient tolerance; the refined one in two stages, float32 to a coarse
tolerance, then float64 from that iterate, both on the card).

Eager PyTorch compiles nothing per shape, so where the reference runs a
whole solve once to compile it, the time-to-tolerance functions warm up
with ``_WARMUP_ITERS`` iterations of the same solve (the kernels' build
and load, the libraries' handles, the allocator's pool): a solve to
tolerance is long (90,171 iterations at d = 2^20 in the reference's
north-star run), and running it twice would double its cost for nothing.
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
from ..types import Status, resolve_device

REFERENCE_SEEDS = (42, 365, 12345, 777777, 10000)
_WARMUP_ITERS = 5


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


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


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
        kernels = resolve_use_pallas(True, dtype,
                                     "bench.harness.solve_callables")
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


def _solve(problem: str, d: int, cfg: LBFGSConfig, dtype,
           with_matvec=False):
    """``run(x0) -> state``: the solve of ``cfg`` from x0 with the
    callables ``solve_callables`` hands over (the fused kernels under
    ``cfg.use_pallas`` for float32; their plain versions, with
    ``resolve_use_pallas``'s warning, for float64)."""
    p = get_problem(problem)
    vg, *callables = solve_callables(problem, d, cfg, dtype, with_matvec)

    def run(x0):
        state = init_state(vg, x0, cfg.m, cfg.history_dtype)
        return solve_from_state(cfg, p.f, vg, state, *callables)
    return run


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
    return fixed_iterations(problem, d, iters, cfg, dtype, seeds, repeats,
                            with_matvec, _cuda_device("bench_gpu"))


def fixed_iterations(problem: str, d: int, iters: int,
                     cfg: Optional[LBFGSConfig], dtype, seeds, repeats: int,
                     with_matvec, device: torch.device) -> BenchResult:
    """``bench_gpu``'s protocol on ``device``, the CPU included (the giant
    cell's ``--device cpu``, for the tests); ``details["device"]`` names
    it.  One state is alive at a time: a run's state is dropped before the
    next run starts, which keeps a giant instance's ring (8 GB at d = 1e8,
    m = 10) resident once."""
    cfg = cfg or LBFGSConfig(line_search="backtracking", direction="compact")
    cfg = cfg.replace(max_iters=iters, tol=0.0)   # tol=0: never stop early
    run = _solve(problem, d, cfg, dtype, with_matvec)
    per_seed, all_walls, warmup_s, out = [], [], None, None
    for seed in seeds:
        x0 = _x0(d, seed, dtype, device)
        out = None
        _sync(device)
        t0 = time.perf_counter()
        out = run(x0)
        _sync(device)
        if warmup_s is None:
            warmup_s = time.perf_counter() - t0
        walls = []
        for _ in range(repeats):
            out = None
            t0 = time.perf_counter()
            out = run(x0)
            _sync(device)
            walls.append(time.perf_counter() - t0)
        all_walls.extend(walls)
        per_seed.append(min(walls))
    wall = float(np.mean(per_seed))
    return BenchResult(
        name=(f"{'gpu' if device.type == 'cuda' else 'cpu'}/{problem}/d={d}/"
              f"{cfg.line_search}/{cfg.direction}/"
              f"{str(dtype).removeprefix('torch.')}"),
        iters_per_s=iters / wall, wall_s=wall, iterations=int(out.k),
        final_f=float(out.f), final_g_norm=float(out.g_norm),
        details={"per_seed_s": per_seed, "repeat_walls_s": all_walls,
                 "warmup_s": warmup_s, "n_fev": int(out.n_fev),
                 "n_gev": int(out.n_gev),
                 "device": _device_name(device)})


def bench_batch(problem: str = "rosenbrock", batch: int = 4096,
                d: int = 1024, iters: int = 200,
                cfg: Optional[LBFGSConfig] = None, dtype=torch.float32,
                seed: int = 42, repeats: int = 3) -> BenchResult:
    """Thousands of independent instances in bounded lockstep on the
    current CUDA device (``solve_bounded`` over a (batch, d) state, as the
    reference's jitted vmap of it).  Reports instance-iterations/s = batch *
    iters / wall, best of ``repeats`` runs after one warm-up, each fenced by
    ``torch.cuda.synchronize()``.  A ``cfg`` with ``use_pallas=True`` runs
    each iteration's tail through the batched ``iteration_tail`` kernel, as
    the reference's runs its Pallas tail under ``jax.vmap``; the default
    configuration leaves it off, as the reference's does.  Raises when no
    CUDA device is present."""
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


def _timed(run, x0, device):
    """(state, wall seconds) of run(x0), fenced by a synchronize and a
    scalar read of the result."""
    _sync(device)
    t0 = time.perf_counter()
    out = run(x0)
    _sync(device)
    float(out.f)
    return out, time.perf_counter() - t0


def time_to_tolerance(problem: str = "rosenbrock", d: int = 1_000_000,
                      tol: float = 1e-5, max_iters: int = 20000,
                      cfg: Optional[LBFGSConfig] = None,
                      dtype=torch.float32, seed: int = 42,
                      device=None) -> dict:
    """Wall time of one solve from ``_x0(d, seed)`` to ||g|| <= ``tol`` on
    ``device`` (``types.resolve_device``: the card unless "cpu" is asked
    for), after a warm-up of ``_WARMUP_ITERS`` iterations; the
    reference's signature, default configuration and keys, plus
    ``device``."""
    device = resolve_device(device)
    cfg = cfg or LBFGSConfig(line_search="backtracking", direction="compact")
    cfg = cfg.replace(max_iters=max_iters, tol=tol)
    x0 = _x0(d, seed, dtype, device)
    _timed(_solve(problem, d, cfg.replace(max_iters=_WARMUP_ITERS), dtype),
           x0, device)
    out, wall = _timed(_solve(problem, d, cfg, dtype), x0, device)
    return {"wall_s": wall, "iterations": int(out.k),
            "status": int(out.status), "g_norm": float(out.g_norm),
            "f": float(out.f), "device": _device_name(device)}


def time_to_tolerance_refined(problem: str = "rosenbrock", d: int = 1 << 20,
                              coarse_tol: float = 1e-3, tol: float = 1e-5,
                              max_iters: int = 150_000,
                              refine_iters: int = 5_000,
                              cfg: Optional[LBFGSConfig] = None,
                              seed: int = 42,
                              refine_backend: str = "torch",
                              device=None) -> dict:
    """Time to ||g|| <= ``tol`` in two stages, the north-star metric of
    the reference (tol = 1e-5 at d = 2^20, below the float32 gradient's
    noise floor there), with its signature and keys, plus ``device``.

    Stage 1 solves in float32 from ``_x0(d, seed)`` to ``coarse_tol`` on
    the main path: the reference's configuration (polynomial backtracking,
    ``compact_incremental``, ``fidelity="fixed"``, the pair skip) with the
    fused kernels (``cfg.use_pallas``; ``solve_callables``).  Stage 2
    warm-starts a fresh-history float64 solve from the float32 iterate, on
    the same device: the card has float64, so ``refine_backend="torch"``
    is the counterpart of the reference's "jax", and the stage takes the
    kernels' plain versions (``problems.suite.resolve_use_pallas`` warns
    and says so: the kernels are float32 programs).  "native", the C++
    oracle on the host, belongs to ``tpu_lbfgs`` and raises.

    Each stage is warmed up with ``_WARMUP_ITERS`` iterations (module
    docstring); each timed stage ends in a synchronize and a scalar read."""
    if refine_backend != "torch":
        raise NotImplementedError(
            f"refine_backend={refine_backend!r} is not ported to "
            "tpu_lbfgs_torch: the C++ oracle ('native') belongs to "
            "tpu_lbfgs; the float64 stage runs on the card with "
            "refine_backend='torch'")
    device = resolve_device(device)
    cfg = cfg or main_path_cfg().replace(fidelity="fixed",
                                         pair_skip_threshold=1e-10)
    cfg32 = cfg.replace(max_iters=max_iters, tol=coarse_tol)
    cfg64 = cfg.replace(max_iters=refine_iters, tol=tol)
    def stages(iters32, iters64):
        run32 = _solve(problem, d, cfg32.replace(max_iters=iters32),
                       torch.float32)
        run64 = _solve(problem, d, cfg64.replace(max_iters=iters64),
                       torch.float64)
        return run32, lambda x32: run64(x32.double())

    x0 = _x0(d, seed, torch.float32, device)
    warm32, warm64 = stages(_WARMUP_ITERS, _WARMUP_ITERS)
    _timed(warm64, _timed(warm32, x0, device)[0].x, device)
    run32, run64 = stages(max_iters, refine_iters)
    coarse, coarse_wall = _timed(run32, x0, device)
    refine, refine_wall = _timed(run64, coarse.x, device)
    return {"wall_s": coarse_wall + refine_wall,
            "coarse_wall_s": coarse_wall, "refine_wall_s": refine_wall,
            "refine_backend": refine_backend,
            "coarse_iterations": int(coarse.k),
            "refine_iterations": int(refine.k),
            "status": Status.NAMES[int(refine.status)],
            "g_norm": float(refine.g_norm), "f": float(refine.f),
            "device": _device_name(device)}
