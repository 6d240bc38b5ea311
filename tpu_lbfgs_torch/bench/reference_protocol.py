"""The reference's published experiment on the card (Table-I analogue;
``tpu_lbfgs.bench.reference_protocol``).

Protocol (cuda_lbfgs.pdf section IV; sequential-implementation/main.cpp:27-52;
parallel-implementation/L-BFGS-Backtracking.cu:429-457):
  - 5 seeded runs averaged, seeds 42, 365, 12345, 777777, 10000;
  - x0 ~ U(-1000, 1000) (``problems.suite.reference_x0``);
  - to convergence: ||g|| <= 1e-8 / at most 15,000 iterations for the
    sequential configuration, ||g|| <= 1e-1 / at most 50,000 for the
    parallel one;
  - per line search, the paper's Table I: Armijo Backtracking, Armijo
    Interpolation, Wolfe Backtracking, Wolfe Interpolation;
  - d = 10,000 (published), 20,000 ("similar trend continues"), 1e5, 2^20.

Backends, each a cell label:
  - ``cpu-native-f64``: REFERENCE_SEQUENTIAL with the C++ oracle
    (``native``, g++ -O3 -march=native, one host thread) in float64 on
    the host, the reference's ``cpu`` backend; ``-scaled`` where the start
    box is not the published one (``run_cpu_cell``'s ``x0_range``).
  - ``cuda-f32-parcfg``: REFERENCE_PARALLEL verbatim (tol 1e-1, C2 = 0.7,
    the alpha-floor rescue, the pair skip) in float32 with direct
    evaluation of every trial, on the fused kernels.  From U(-1000, 1000)
    the rescue overflows float32 for the plain Armijo searches, and the
    interpolating searches fail at iteration 1 (``line_search_failed``), as
    they do in the reference: reproduced, not repaired.
  - ``cuda-f32-norescue``: the same with ``alpha_rescue_floor=None``.
  - ``cuda-f64``: REFERENCE_SEQUENTIAL (tol 1e-8, C2 = 0.9, max 15,000) in
    real float64 on the card, on the kernels' plain versions (the kernels
    are float32 programs).  The reference's TPU emulated float64 and ran
    large cells in segments to keep its worker alive
    (``F64_SEGMENT_THRESHOLD``); neither applies here.

Each (d, strategy) where the float32 cell iterated gets the reference's
Fig.-1 row: ``cuda_per_iter_speedup``, its per-iteration rate over the
CPU cell's, and ``f32_over_f64_per_iter``, over the float64 cell's,
where those ran (the units are iterations: the cells stop at different
tolerances).

A CUDA cell runs its seeds until the next would overrun ``budget_s``
(measured solve walls only); ``seeds_run`` says how many.  A CPU cell
first runs a 200-iteration probe and is skipped when one seed's 15,000
iterations, projected from it, would overrun its budget, as the
reference's is.  Each seed is timed after a
warm-up of ``harness._WARMUP_ITERS`` iterations from the first seed (eager
PyTorch compiles nothing per shape).  ``run_protocol`` runs each cell in
its own interpreter (a new process, never a fork of one that holds a CUDA
context; a CPU cell's never makes one), killed at ``cell_timeout_s``;
``jobs`` cells at a time share the card, whose solves here are bound by
the host's launches and reads.
``jobs`` > 1 departs from the reference's sequential grid: the cells'
walls then include the sharing, so the budget runs fewer seeds than the
card alone would, and the report keeps no rate (no ``iters_per_s``, no
speed-ups); the seeds' iterations and statuses do not depend on it.
"""
from __future__ import annotations

import json
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..config import REFERENCE_PARALLEL, REFERENCE_SEQUENTIAL
from ..problems.suite import reference_x0
from ..types import Status, resolve_device
from .harness import (
    _WARMUP_ITERS,
    REFERENCE_SEEDS,
    _device_name,
    _solve,
    _timed,
    host_cpu,
)

# Paper Table I rows -> the solver's strategy names.
TABLE_I_STRATEGIES = (
    ("Armijo Backtracking", "backtracking"),
    ("Armijo Interpolation", "armijo_interpolation"),
    ("Wolfe Backtracking", "backtracking_wolfe"),
    ("Wolfe Interpolation", "wolfe_interpolation"),
)

DIMS = (10_000, 20_000, 100_000, 1 << 20)

BACKENDS = ("cuda-f32-parcfg", "cuda-f32-norescue", "cuda-f64", "cpu")
PUBLISHED_BOX = (-1000.0, 1000.0)


def _status_name(s) -> str:
    return s if isinstance(s, str) else Status.NAMES.get(int(s), str(s))


class _CellTimeout(Exception):
    pass


def _alarm(_s, _f):
    raise _CellTimeout()


def run_cuda_cell(problem: str, d: int, strategy: str,
                  seeds=REFERENCE_SEEDS, use_pallas: bool = True,
                  dtype: str = "float32", budget_s: float = 600.0,
                  no_rescue: bool = False, device=None) -> dict:
    """To-convergence runs of one (problem, d, strategy) on ``device``
    (``types.resolve_device``: the card unless "cpu" is asked for), the
    counterpart of the reference's ``run_tpu_cell``.

    dtype="float32": REFERENCE_PARALLEL with ``line_search=strategy``,
    ``compact_incremental`` and ``ls_eval="direct"`` (the reference
    evaluates every trial; from U(-1000, 1000) the degree-4 directional
    polynomial's coefficients overflow float32), on the fused kernels
    under ``use_pallas``; ``no_rescue`` turns the alpha-floor rescue off.
    dtype="float64": REFERENCE_SEQUENTIAL, the same direction and search
    evaluation, no kernels."""
    device = resolve_device(device)
    if dtype == "float64":
        cfg = REFERENCE_SEQUENTIAL.replace(
            line_search=strategy, direction="compact_incremental",
            ls_eval="direct", use_pallas=False, history_dtype=None)
        tdtype = torch.float64
    else:
        cfg = REFERENCE_PARALLEL.replace(
            line_search=strategy, direction="compact_incremental",
            ls_eval="direct", use_pallas=use_pallas,
            alpha_rescue_floor=None if no_rescue
            else REFERENCE_PARALLEL.alpha_rescue_floor)
        tdtype = torch.float32
    def x0_of(seed):
        return reference_x0(d, seed, dtype=tdtype, device=device)

    warmup_s = _timed(_solve(problem, d, cfg.replace(max_iters=_WARMUP_ITERS),
                             tdtype), x0_of(seeds[0]), device)[1]
    run = _solve(problem, d, cfg, tdtype)
    walls, iters, fs, gnorms, statuses = [], [], [], [], []
    for seed in seeds:
        # Stop adding seeds when the next, projected from the slowest so
        # far, would overrun the budget.
        if walls and (sum(walls) + max(walls)) > budget_s:
            break
        out, wall = _timed(run, x0_of(seed), device)
        walls.append(wall)
        iters.append(int(out.k))
        fs.append(float(out.f))
        gnorms.append(float(out.g_norm))
        statuses.append(int(out.status))
    if dtype == "float64":
        label = "cuda-f64"
    else:
        label = "cuda-f32-norescue" if no_rescue else "cuda-f32-parcfg"
    cell = _summarize(label, walls, iters, fs, gnorms, statuses, len(seeds))
    cell["warmup_s"] = round(warmup_s, 2)
    cell["device"] = _device_name(device)
    return cell


def run_cpu_cell(problem: str, d: int, strategy: str,
                 seeds=REFERENCE_SEEDS, budget_s: float = 600.0,
                 x0_range=PUBLISHED_BOX) -> dict:
    """To-convergence runs of the C++ oracle on the host under
    REFERENCE_SEQUENTIAL (tol 1e-8, at most 15,000 iterations) in float64,
    the reference's ``run_cpu_cell``, from ``reference_x0`` (the CUDA
    cells' starts).  It touches no CUDA device.

    A 200-iteration probe of the same configuration from the first seed
    comes first: where it does not converge and one seed's 15,000
    iterations, projected from it, would overrun ``budget_s``, the cell is
    skipped.  Otherwise seeds run until the next would overrun the budget
    (time since the first seed plus the slowest seed so far); ``seeds_run``
    says how many.  ``x0_range``: another start box, labelled
    ``cpu-native-f64-scaled``."""
    from ..native import native_lbfgs

    cfg = REFERENCE_SEQUENTIAL.replace(line_search=strategy)
    label = ("cpu-native-f64" if tuple(x0_range) == PUBLISHED_BOX
             else "cpu-native-f64-scaled")

    def x0_of(seed):
        return reference_x0(d, seed, *x0_range, device="cpu").numpy()

    probe_iters = 200
    x0_probe = x0_of(seeds[0])          # drawn outside the timed probe
    t0 = time.perf_counter()
    probe = native_lbfgs(problem, x0_probe, cfg.replace(max_iters=probe_iters))
    probe_wall = time.perf_counter() - t0
    if probe["status"] != "converged":
        projected = probe_wall * (cfg.max_iters / probe_iters)
        if projected > budget_s:
            return {"backend": label, "seeds_run": 0, "skipped": "budget",
                    "projected_wall_s_per_seed": round(projected, 1),
                    "probe_iters_per_s": round(probe_iters / probe_wall, 2)}

    walls, iters, fs, gnorms, statuses = [], [], [], [], []
    t_start = time.perf_counter()
    for seed in seeds:
        if walls and time.perf_counter() - t_start + max(walls) > budget_s:
            break
        x0 = x0_of(seed)
        t0 = time.perf_counter()
        r = native_lbfgs(problem, x0, cfg)
        walls.append(time.perf_counter() - t0)
        iters.append(int(r["iterations"]))
        fs.append(float(r["f"]))
        gnorms.append(float(r["g_norm"]))
        statuses.append(r["status"])
    cell = _summarize(label, walls, iters, fs, gnorms, statuses, len(seeds))
    cell["device"] = host_cpu()
    return cell


def _run_backend(problem, d, strategy, backend, seeds, budget_s,
                 device=None) -> dict:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "cpu":
        return run_cpu_cell(problem, d, strategy, seeds, budget_s=budget_s)
    return run_cuda_cell(problem, d, strategy, seeds,
                         dtype="float64" if backend == "cuda-f64"
                         else "float32",
                         budget_s=budget_s,
                         no_rescue=backend == "cuda-f32-norescue",
                         device=device)


def _summarize(backend, walls, iters, fs, gnorms, statuses, n_seeds) -> dict:
    if not walls:
        return {"backend": backend, "seeds_run": 0, "skipped": "budget"}
    mean_wall = float(np.mean(walls))
    mean_iters = float(np.mean(iters))
    return {
        "backend": backend,
        "seeds_run": len(walls),
        "seeds_total": n_seeds,
        "mean_wall_s": round(mean_wall, 4),
        "mean_iterations": round(mean_iters, 1),
        "iters_per_s": round(mean_iters / mean_wall, 1) if mean_wall else None,
        "mean_final_f": float(np.mean(fs)),
        "max_final_g_norm": float(np.max(gnorms)),
        "statuses": [_status_name(s) for s in statuses],
        "per_seed_wall_s": [round(w, 3) for w in walls],
        "per_seed_iterations": iters,
    }


def _cell_ran(c: dict) -> bool:
    """Whether a cell's iters_per_s is an iteration rate: every seed
    converged or reached max_iters (a failed-at-iteration-1 seed's wall
    is set-up, not iterations)."""
    statuses = c.get("statuses", ())
    return bool(c.get("iters_per_s") and statuses
                and all(s in ("converged", "max_iters") for s in statuses))


def _cell_rate(c: dict):
    """(iters_per_s, seeds_used) over the seeds that iterated (converged /
    max_iters); (None, 0) when none did."""
    statuses = c.get("statuses", ())
    if _cell_ran(c):
        return c["iters_per_s"], len(statuses)
    walls = c.get("per_seed_wall_s", ())
    iters = c.get("per_seed_iterations", ())
    if not statuses or len(walls) != len(statuses) \
            or len(iters) != len(statuses):
        return None, 0
    pairs = [(w, i) for s, w, i in zip(statuses, walls, iters)
             if s in ("converged", "max_iters")]
    if not pairs:
        return None, 0
    mean_wall = sum(w for w, _ in pairs) / len(pairs)
    mean_iters = sum(i for _, i in pairs) / len(pairs)
    if not mean_wall or not mean_iters:
        return None, 0
    return mean_iters / mean_wall, len(pairs)


def _one_cell(problem, d, strategy, backend, seeds, budget_s,
              cell_timeout_s, isolate, device):
    """One cell, its failure recorded in it: the grid goes on."""
    if isolate:
        return _cell_subprocess(problem, d, strategy, backend, seeds,
                                budget_s, cell_timeout_s, device)
    signal.alarm(cell_timeout_s)
    try:
        return _run_backend(problem, d, strategy, backend, seeds, budget_s,
                            device=device)
    except _CellTimeout:
        return {"backend": backend, "error": "cell timeout"}
    except Exception as e:  # noqa: BLE001 - record, continue
        return {"backend": backend, "error": f"{type(e).__name__}: {e}"}
    finally:
        signal.alarm(0)


def run_protocol(problem: str = "rosenbrock", dims=DIMS,
                 seeds=REFERENCE_SEEDS, cuda_budget_s: float = 600.0,
                 cell_timeout_s: int = 900,
                 out: Optional[str] = "torch_reference_protocol_results.json",
                 quick: bool = False, isolate: bool = True,
                 cuda_f64: bool = False, jobs: int = 1,
                 device=None, cpu: bool = True, cuda: bool = True,
                 cpu_budget_s: float = 600.0,
                 strategies=TABLE_I_STRATEGIES) -> dict:
    """Run the per-strategy, per-dimension grid, print each cell as it
    ends and the markdown table at the end, and return (and write to
    ``out``) the report.  Backends: under ``cuda``, the two float32 ones
    (and ``cuda-f64`` under ``cuda_f64``) on ``device``
    (``types.resolve_device``: without one, the card, and no card raises);
    under ``cpu``, the C++ oracle's (``run_cpu_cell``, ``cpu_budget_s``),
    which needs no card.  ``strategies``: rows of ``TABLE_I_STRATEGIES``.
    ``quick``: the first d and the first 2 seeds.  ``isolate``: each cell
    in its own interpreter, killed at ``cell_timeout_s``, up to ``jobs`` at
    a time; otherwise in this process under an alarm (the tests)."""
    card = _device_name(resolve_device(device)) if cuda else None
    if quick:
        dims = dims[:1]
        seeds = seeds[:2]
    backends = ((BACKENDS[:3] if cuda_f64 else BACKENDS[:2]) if cuda
                else ()) + (("cpu",) if cpu else ())
    grid = [(d, label, strategy, backend) for d in dims
            for label, strategy in strategies for backend in backends]
    if not isolate:
        signal.signal(signal.SIGALRM, _alarm)

    def cell_of(item):
        d, label, strategy, backend = item
        t0 = time.perf_counter()
        budget = cpu_budget_s if backend == "cpu" else cuda_budget_s
        cell = _one_cell(problem, d, strategy, backend, seeds, budget,
                         cell_timeout_s, isolate, device)
        cell.update({"d": d, "strategy": label, "strategy_key": strategy,
                     "cell_wall_s": round(time.perf_counter() - t0, 1)})
        print(_cell_line(cell), flush=True)
        return cell

    shared = isolate and jobs > 1
    if shared:
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            cells = list(pool.map(cell_of, grid))
        # The cells' walls include the sharing: no rate is the card's.
        for c in cells:
            c.pop("iters_per_s", None)
    else:
        cells = [cell_of(item) for item in grid]

    speedups = [] if shared else _speedups(cells, dims, strategies)
    report = {
        "problem": problem,
        "device": card,
        "cpu": host_cpu() if cpu else None,
        "concurrent_cells": jobs if shared else 1,
        "protocol": {
            "x0": "U(-1000, 1000), seeds " + ", ".join(map(str, seeds))
                  + " (numpy default_rng)",
            "cpu_config": "sequential reference: tol=1e-8, max_iters=15000, "
                          "m=10, C2=0.9, float64 (main.cpp:48-51), the C++ "
                          "oracle on one host thread",
            "cuda_f32_parcfg": "parallel reference verbatim: tol=1e-1, "
                               "max_iters=50000, m=10, C2=0.7, rescue+skip, "
                               "float32, direct evaluation, fused kernels",
            "cuda_f32_norescue": "the same with the alpha-floor rescue off",
            "cuda_f64": "sequential reference: tol=1e-8, max_iters=15000, "
                        "m=10, C2=0.9, float64 on the card, plain versions",
        },
        "cells": cells,
        "per_iteration_speedups": speedups,
    }
    if out:
        with open(out, "w") as fh:
            json.dump(report, fh, indent=1)
        print(f"wrote {out}")
    print()
    print(markdown_table(report))
    return report


def _speedups(cells, dims, strategies) -> list:
    """The reference's Fig.-1 rows: for each (d, strategy) where the
    float32 cell (``cuda-f32-norescue``) iterated, its per-iteration rate
    over the CPU cell's (``cuda_per_iter_speedup``) and over the float64
    cell's (``f32_over_f64_per_iter``), each where that cell iterated;
    ``seeds_used`` where a rate counts only some of a cell's seeds (those
    that converged or reached max_iters)."""
    rows = []
    for d in dims:
        for label, _ in strategies:
            def cell(backend):
                return next((c for c in cells if c["d"] == d
                             and c["strategy"] == label
                             and c.get("backend") == backend), None)

            f32 = cell("cuda-f32-norescue")
            r32, used32 = _cell_rate(f32) if f32 else (None, 0)
            if not r32:
                continue
            row, used = {"d": d, "strategy": label}, {"f32": used32}
            partial = used32 < len(f32.get("statuses", ()))
            for key, backend, digits, name in (
                    ("cuda_per_iter_speedup", "cpu-native-f64", 3, "cpu"),
                    ("f32_over_f64_per_iter", "cuda-f64", 2, "f64")):
                other = cell(backend)
                rate, n = _cell_rate(other) if other else (None, 0)
                if rate:
                    row[key] = round(r32 / rate, digits)
                    used[name] = n
                    partial |= n < len(other.get("statuses", ()))
            if len(row) == 2:
                continue
            if partial:
                row["seeds_used"] = used
            rows.append(row)
    return rows


def _cell_subprocess(problem: str, d: int, strategy: str, backend: str,
                     seeds, budget_s: float, timeout_s: int,
                     device=None) -> dict:
    """One cell in a new interpreter (never a fork of a process that holds
    a CUDA context), killed at ``timeout_s``."""
    cmd = [sys.executable, "-m", "tpu_lbfgs_torch.bench.reference_protocol",
           "--cell", "--problem", problem, "--d", str(d),
           "--strategy", strategy, "--backend", backend,
           "--budget", str(budget_s),
           "--seeds"] + [str(s) for s in seeds]
    if device is not None:
        cmd += ["--device", str(device)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"backend": backend, "error": "cell timeout (killed)",
                "waited_s": timeout_s}
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.startswith("{")]
    if r.returncode != 0 or not lines:
        tail = (r.stderr or r.stdout).strip().splitlines()[-3:]
        return {"backend": backend,
                "error": f"cell exited {r.returncode}: {' | '.join(tail)}"}
    return json.loads(lines[-1])


def _cell_main(argv=None) -> int:
    """The cell process: run one cell, print it as one JSON line."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="store_true")
    ap.add_argument("--problem", required=True)
    ap.add_argument("--d", type=int, required=True)
    ap.add_argument("--strategy", required=True)
    ap.add_argument("--backend", required=True, choices=BACKENDS)
    ap.add_argument("--budget", type=float, default=600.0)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=list(REFERENCE_SEEDS))
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    cell = _run_backend(args.problem, args.d, args.strategy, args.backend,
                        tuple(args.seeds), args.budget, device=args.device)
    cell.update({"d": args.d, "strategy_key": args.strategy})
    print(json.dumps(cell))
    return 0


def _cell_line(c: dict) -> str:
    head = f"{c['backend']:17s} d={c['d']:<8d} {c['strategy']:22s}"
    if "error" in c:
        return f"{head} ERROR {c['error']}"
    if c.get("skipped"):
        return f"{head} SKIPPED ({c['skipped']})"
    return (f"{head} {c['mean_wall_s']:9.3f}s  {c['mean_iterations']:8.1f} it"
            f"  ||g||<={c['max_final_g_norm']:.2e}"
            f"  [{c['seeds_run']}/{c['seeds_total']} seeds]")


def markdown_table(report: dict) -> str:
    """The report's cells as a markdown table."""
    lines = [
        "| d | strategy | backend | mean wall (s) | mean iters | it/s |"
        " final f (mean) | status | seeds |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for c in report["cells"]:
        if "error" in c:
            lines.append(f"| {c['d']:,} | {c['strategy']} | {c['backend']} |"
                         f" — | — | — | — | {c['error']} | 0 |")
            continue
        if c.get("skipped"):
            lines.append(f"| {c['d']:,} | {c['strategy']} | {c['backend']} |"
                         f" — | — | — | — | skipped ({c['skipped']}) | 0 |")
            continue
        status = max(set(c["statuses"]), key=c["statuses"].count)
        rate = f"{c['iters_per_s']:,}" if c.get("iters_per_s") else "—"
        lines.append(
            f"| {c['d']:,} | {c['strategy']} | {c['backend']} |"
            f" {c['mean_wall_s']:.3f} | {c['mean_iterations']:.0f} |"
            f" {rate} | {c['mean_final_f']:.3e} |"
            f" {status} | {c['seeds_run']}/{c['seeds_total']} |")
    return "\n".join(lines)


if __name__ == "__main__":
    sys.exit(_cell_main())
