"""Throughput and time to tolerance of the port on the GPU, with the
protocols of ``tpu_lbfgs.bench.harness``: ``bench_gpu`` as ``bench_tpu``
(the same starting points (_x0), tol=0 so that every run does the same
iterations, one warm-up run, best of ``repeats`` timed runs per seed, mean
over seeds), ``bench_batch`` as its namesake (a batch of instances in
bounded lockstep, instance-iterations/s), and ``time_to_tolerance`` /
``time_to_tolerance_refined`` as theirs (the wall time of a solve to a
gradient tolerance; the refined one in two stages, float32 to a coarse
tolerance, then float64 from that iterate, on the card or with the C++
oracle on the host).  ``bench_cpu_native`` times the CPU baseline as its
namesake does: the C++ oracle (``native``) in float64 on one host thread,
at a fixed number of iterations.

The solves run in blocks of iterations replayed as CUDA graphs
(``core.blocks``), and every function here keeps its solve's block runner
across its runs (``blocks.Kept``): the warm-up captures the graphs, where
the reference compiles its solve, and the timed runs replay them.  Beside each
rate stand the capture seconds of the warm-up and the host reads and
iterations stepped per timed solve (``_blocks_details``).  Where the
reference runs a whole solve once to compile it, the time-to-tolerance
functions warm up with ``_warmup_iters()`` iterations of the same solve
(the kernels' build and load, the libraries' handles, the allocator's
pool, a full block's graph and a single iteration's): a solve to
tolerance is long (90,171 iterations at d = 2^20 in the reference's
north-star run), and running it twice would double its cost for nothing.
"""
from __future__ import annotations

import platform
import time
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..config import LBFGSConfig
from ..core import blocks
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


def _warmup_iters() -> int:
    """Warm-up iterations of a time-to-tolerance solve: ``_WARMUP_ITERS``,
    and enough that the warm-up captures (``blocks.CAPTURE_MIN_ITERS``)
    both graphs the solve replays, a full block's and a single
    iteration's."""
    n = max(_WARMUP_ITERS, blocks.CAPTURE_MIN_ITERS, blocks.BLOCK_ITERS)
    return n + 1 if n % blocks.BLOCK_ITERS == 0 else n


def _since(before: dict) -> dict:
    """``blocks.stats`` since the snapshot ``before``."""
    return {k: v - before[k] for k, v in blocks.stats.items()}


def _blocks_details(capture_s: float, timed: dict, solves: int) -> dict:
    """The block runner's numbers beside a rate: the warm-up's capture
    seconds, and host reads and iterations stepped (frozen ones included)
    per timed solve, from ``timed``, ``_since`` the timed runs began."""
    return {"capture_s": capture_s,
            "host_reads_per_solve": timed["host_reads"] / solves,
            "steps_per_solve": timed["steps"] / solves}


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
    """``run(x0, iters=None) -> state``: the solve of ``cfg`` (with
    ``max_iters=iters`` when given) from x0 with the callables
    ``solve_callables`` hands over once for every run (the fused kernels
    under ``cfg.use_pallas`` for float32; their plain versions, with
    ``resolve_use_pallas``'s warning, for float64), keeping one block
    runner for every run (``blocks.Kept``), so that a run replays the
    graphs an earlier one captured and returns the kept buffers, which the
    next run overwrites."""
    p = get_problem(problem)
    vg, *callables = solve_callables(problem, d, cfg, dtype, with_matvec)
    kept = blocks.Kept()

    def run(x0, iters=None):
        run_cfg = cfg if iters is None else cfg.replace(max_iters=iters)
        state = init_state(vg, x0, run_cfg.m, run_cfg.history_dtype)
        return solve_from_state(run_cfg, p.f, vg, state, *callables,
                                kept=kept)
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
    it.  The warm-up run captures the solve's graphs and the timed runs
    replay them (``_solve``); ``details`` carries the capture
    seconds and the host reads per solve (``_blocks_details``).  The kept
    runner's buffers hold one state, into which each run's start is
    copied: at most two rings are alive (a giant instance's is 8 GB at d =
    1e8, m = 10), the kept one and a new start's until it is copied in."""
    cfg = cfg or LBFGSConfig(line_search="backtracking", direction="compact")
    cfg = cfg.replace(max_iters=iters, tol=0.0)   # tol=0: never stop early
    run = _solve(problem, d, cfg, dtype, with_matvec)
    per_seed, all_walls, warmup_s, out = [], [], None, None
    capture_s, timed = 0.0, None
    for seed in seeds:
        x0 = _x0(d, seed, dtype, device)
        out = None
        _sync(device)
        t0 = time.perf_counter()
        before = dict(blocks.stats)
        out = run(x0)
        _sync(device)
        capture_s += _since(before)["capture_s"]
        if warmup_s is None:
            warmup_s = time.perf_counter() - t0
        walls = []
        before = dict(blocks.stats)
        for _ in range(repeats):
            out = None
            t0 = time.perf_counter()
            out = run(x0)
            _sync(device)
            walls.append(time.perf_counter() - t0)
        timed = _since(before)
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
                 # reads and steps: the last seed's timed runs
                 **_blocks_details(capture_s, timed, repeats),
                 "device": _device_name(device)})


def host_cpu() -> str:
    """The host CPU, where the C++ oracle runs: the model name of
    ``/proc/cpuinfo``'s first processor, with its vendor, family and model
    numbers where the name is missing or "unknown" (as some virtual
    machines report it); the machine's architecture where the file cannot
    be read."""
    info = {}
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if not line.strip():
                    break                   # the first processor only
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        return platform.machine() or "unknown cpu"
    name = info.get("model name") or "unknown"
    if name == "unknown":
        name += " (" + ", ".join(f"{k} {info.get(k, '?')}" for k in
                                 ("vendor_id", "cpu family", "model")) + ")"
    return name


def bench_cpu_native(problem: str = "rosenbrock", d: int = 1_000_000,
                     iters: int = 20, cfg: Optional[LBFGSConfig] = None,
                     seeds=REFERENCE_SEEDS[:1],
                     repeats: int = 3) -> BenchResult:
    """Fixed-iteration throughput of the C++ oracle on the host, the CPU
    baseline (``tpu_lbfgs.bench.harness.bench_cpu_native``): float64 from
    ``_x0(d, seed)``, tol = 0, best of ``repeats`` runs per seed (the
    host's speed spreads between runs; the best is its capability and the
    conservative side of a ratio over it), mean over seeds.  It runs on
    the host whatever the card; ``details`` carries every run's wall and
    the CPU's name."""
    from ..native import native_lbfgs

    cfg = cfg or LBFGSConfig(line_search="backtracking")
    cfg = cfg.replace(max_iters=iters, tol=0.0)
    per_seed, all_walls, r = [], [], None
    for seed in seeds:
        x0 = _x0(d, seed, torch.float64).numpy()
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            r = native_lbfgs(problem, x0, cfg)
            walls.append(time.perf_counter() - t0)
        all_walls.extend(walls)
        per_seed.append(min(walls))
    wall = float(np.mean(per_seed))
    return BenchResult(
        name=f"cpu-native/{problem}/d={d}/{cfg.line_search}",
        iters_per_s=iters / wall, wall_s=wall, iterations=iters,
        final_f=r["f"], final_g_norm=r["g_norm"],
        details={"per_seed_s": per_seed, "repeat_walls_s": all_walls,
                 "n_fev": r["n_fev"], "n_gev": r["n_gev"],
                 "device": host_cpu()})


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

    kept = blocks.Kept()

    def run():
        state = init_state(vg, x0s, cfg.m, cfg.history_dtype)
        return solve_bounded(cfg, p.f, vg, state, dir_poly, kept=kept)

    before = dict(blocks.stats)
    out = run()
    torch.cuda.synchronize()
    capture_s = _since(before)["capture_s"]
    walls = []
    before = dict(blocks.stats)
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    timed = _since(before)
    best = min(walls)
    return BenchResult(
        name=f"gpu-batch/{problem}/B={batch}/d={d}/{cfg.line_search}",
        iters_per_s=batch * iters / best, wall_s=best, iterations=iters,
        final_f=float(out.f.mean()), final_g_norm=float(out.g_norm.max()),
        details={"batch": batch, "per_instance_iters_per_s": iters / best,
                 "repeat_walls_s": walls,
                 "status_counts": torch.bincount(out.status.long(), minlength=4)
                 .tolist(),
                 **_blocks_details(capture_s, timed, repeats),
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
    for), after a warm-up of ``_warmup_iters()`` iterations that captures
    its graphs; the reference's signature, default configuration and
    keys, plus ``device`` and ``_blocks_details``'."""
    device = resolve_device(device)
    cfg = cfg or LBFGSConfig(line_search="backtracking", direction="compact")
    cfg = cfg.replace(max_iters=max_iters, tol=tol)
    x0 = _x0(d, seed, dtype, device)
    run = _solve(problem, d, cfg, dtype)
    before = dict(blocks.stats)
    _timed(lambda x: run(x, _warmup_iters()), x0, device)
    capture_s = _since(before)["capture_s"]
    before = dict(blocks.stats)
    out, wall = _timed(run, x0, device)
    return {"wall_s": wall, "iterations": int(out.k),
            "status": int(out.status), "g_norm": float(out.g_norm),
            "f": float(out.f),
            **_blocks_details(capture_s, _since(before), 1),
            "device": _device_name(device)}


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
    warm-starts a fresh-history float64 solve from the float32 iterate.
    ``refine_backend="torch"``, the default, runs it on the same device:
    the card has float64, so this is the counterpart of the reference's
    "jax", and the stage takes the kernels' plain versions
    (``problems.suite.resolve_use_pallas`` warns and says so: the kernels
    are float32 programs).  ``refine_backend="native"`` runs it with the
    C++ oracle on the host from ``coarse.x.double().cpu().numpy()``, the
    copy inside the stage's wall, as the reference does by default (its
    TPU's float64 is emulated); the oracle takes the configuration's line
    search, fidelity and constants and runs its own two-loop direction.

    Each stage is warmed up with ``_warmup_iters()`` iterations, which
    capture its graphs (module docstring) or load the oracle; each timed
    stage ends in a synchronize and a scalar read."""
    if refine_backend not in ("torch", "native"):
        raise ValueError(f"refine_backend must be 'torch' or 'native', got "
                         f"{refine_backend!r}")
    device = resolve_device(device)
    cfg = cfg or main_path_cfg().replace(fidelity="fixed",
                                         pair_skip_threshold=1e-10)
    run32 = _solve(problem, d, cfg.replace(max_iters=max_iters,
                                           tol=coarse_tol), torch.float32)
    cfg64 = cfg.replace(max_iters=refine_iters, tol=tol)
    if refine_backend == "native":
        run64 = _native_run(problem, cfg64)
    else:
        run64 = _solve(problem, d, cfg64, torch.float64)
    x0 = _x0(d, seed, torch.float32, device)
    before = dict(blocks.stats)
    warm = _timed(lambda x: run32(x, _warmup_iters()), x0, device)[0]
    # The float32 stage's state is the kept buffers: the float64 stage
    # starts from a copy of its x.
    _timed(lambda x: run64(x, _warmup_iters()), warm.x.double(), device)
    capture_s = _since(before)["capture_s"]
    before = dict(blocks.stats)
    coarse, coarse_wall = _timed(run32, x0, device)
    refine, refine_wall = _timed(run64, coarse.x.double(), device)
    timed = _blocks_details(capture_s, _since(before), 1)
    return {"wall_s": coarse_wall + refine_wall,
            "coarse_wall_s": coarse_wall, "refine_wall_s": refine_wall,
            "refine_backend": refine_backend,
            "coarse_iterations": int(coarse.k),
            "refine_iterations": int(refine.k),
            "status": Status.NAMES[int(refine.status)],
            "g_norm": float(refine.g_norm), "f": float(refine.f),
            **timed, "device": _device_name(device)}


def _native_run(problem: str, cfg: LBFGSConfig):
    """``run(x, iters=None)``: the C++ oracle under ``cfg`` (with
    ``max_iters=iters`` when given) from a copy of the float64 x on the
    host; its result under the state's names, for ``_timed`` and the
    stage's record."""
    from ..native import native_lbfgs

    codes = {name: code for code, name in Status.NAMES.items()}

    def run(x, iters=None):
        run_cfg = cfg if iters is None else cfg.replace(max_iters=iters)
        r = native_lbfgs(problem, x.cpu().numpy(), run_cfg)
        return SimpleNamespace(k=r["iterations"], status=codes[r["status"]],
                               g_norm=r["g_norm"], f=r["f"])
    return run
