"""Strong scaling of the sharded solve (``tpu_lbfgs.bench.scaling``):
iterations/s of one global problem at 1 rank against N ranks,
eff(N) = T(1) / T(N) / N.

Each count runs as its own job of N processes (``dist.launch.spawn_ranks``;
one count in this process), every rank solving its block of the same
d-vector for a fixed number of iterations (tol = 0) on the shard-local
kernels (``stack`` "kernels-shard", with "+matvec" for the history
products in the tail; "kernels-unsharded" at one rank) or the plain
shard-local path ("plain-shard" / "plain-unsharded").

Collectives: nccl with a card per rank.  Where the job has fewer cards than
ranks, the ranks share the cards over gloo, which moves every CUDA
collective through the host; such a row says so in its ``backend`` field
("gloo, 4 ranks on 1 card") and measures the sharing, not the scaling, and
the sweep marks its efficiencies ``scaling: false``.

Command line (prints one JSON row per count, then the sweep):
  python -m tpu_lbfgs_torch.bench.scaling --problem rosenbrock --d 4194304 --iters 50 --counts 1 2 4
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import LBFGSConfig
from ..types import resolve_device

#: A row's ``note`` where the ranks share cards: no scaling number.
SHARED_NOTE = "ranks share a card over gloo: not a scaling number"


def _backend(n: int, dev: torch.device) -> tuple[str, int]:
    """(collective backend, cards the job uses) for n ranks on dev."""
    if dev.type != "cuda":
        return "gloo", 0
    cards = torch.cuda.device_count()
    return ("nccl", n) if n <= cards else ("gloo", cards)


def _timed_rank(rank: int, size: int, problem: str, d: int, iters: int,
                cfg: LBFGSConfig, dtype: str, repeats: int, seed: int,
                kernels: bool, with_matvec: bool, device: Optional[str]):
    """One rank's timed solves: each repeat starts from a fresh state (the
    ring is updated in place), after a barrier, and ends with the read of
    f; the first run warms up (kernel build, first launches)."""
    import torch.distributed as dist

    from ..core.solver import init_state
    from ..dist.mesh import local_block, make_mesh, pad_for_mesh
    from ..dist.sharded import shard_objective, solve_shard_from_state

    dev = resolve_device(device)
    mesh = make_mesh()
    rng = np.random.default_rng(seed)
    x0 = torch.from_numpy(rng.uniform(-2.0, 2.0, d)).to(
        dev, getattr(torch, dtype))
    x_pad, n = pad_for_mesh(x0, mesh.size)
    x_local = local_block(x_pad, mesh)
    cfg = cfg.replace(max_iters=iters, tol=0.0)
    obj = shard_objective(problem, n, cfg, mesh, kernels, with_matvec)
    walls, f = [], None
    for r in range(repeats + 1):
        state = init_state(obj.vg, x_local.clone(), cfg.m, cfg.history_dtype,
                           comm=mesh.comm)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if dist.is_initialized():
            dist.barrier()
        t0 = time.perf_counter()
        res, _ = solve_shard_from_state(state, n, cfg, mesh, problem,
                                        kernels, with_matvec)
        f = float(res.f)                # waits for the device
        if r:
            walls.append(time.perf_counter() - t0)
    return {"walls": walls, "final_f": f, "iterations": int(res.iterations)}


def bench_sharded(problem: str, d: int, iters: int, cfg: LBFGSConfig,
                  n_devices: int, dtype: str = "float32", repeats: int = 3,
                  seed: int = 42, use_pallas: Optional[bool] = None,
                  with_matvec: bool = False, device=None) -> dict:
    """Fixed-iteration throughput with the vector sharded over
    ``n_devices`` ranks (processes), on the card unless ``device="cpu"``.
    ``use_pallas``: None takes the shard-local kernels for a float32
    problem that has them on the card, and the plain path elsewhere (on
    the CPU the kernels are their plain versions, no benchmark); True for
    a problem or dtype without kernels warns and runs the plain path, as
    the reference does.  Returns the reference's row (``n_devices``,
    ``iters_per_s``, ``wall_s``, ``final_f``, ``stack``) with the
    ``backend``, the ``cards`` used and, where ranks share a card, a
    ``note``."""
    from ..dist.launch import spawn_ranks
    from ..dist.pallas_sharded import SHARDED_PALLAS_PROBLEMS

    dev = resolve_device(device)
    has_kernels = problem in SHARDED_PALLAS_PROBLEMS and dtype == "float32"
    if use_pallas is None:
        use_pallas = has_kernels and dev.type == "cuda"
    elif use_pallas and not has_kernels:
        import warnings

        warnings.warn(
            f"no shard-local kernels for problem={problem!r} dtype={dtype}; "
            f"benchmarking the plain path", RuntimeWarning, stacklevel=2)
        use_pallas = False
    backend, cards = _backend(n_devices, dev)
    args = (problem, d, iters, cfg, dtype, repeats, seed, use_pallas,
            with_matvec, "cpu" if dev.type == "cpu" else None)
    if n_devices == 1:
        out = _timed_rank(0, 1, *args)
    else:
        out = spawn_ranks(_timed_rank, n_devices, *args, backend=backend,
                          timeout_s=600.0, threads=None)[0]
    wall = min(out["walls"])
    stack = ("kernels" if use_pallas else "plain") + (
        "-shard" if n_devices > 1 else "-unsharded")
    if use_pallas and with_matvec:
        stack += "+matvec"
    row = {"n_devices": n_devices, "iters_per_s": iters / wall,
           "wall_s": wall, "final_f": out["final_f"], "stack": stack,
           "backend": backend if n_devices > 1 else "none",
           "cards": cards, "device": str(dev)}
    if dev.type == "cuda":
        row["device_name"] = torch.cuda.get_device_name(dev)
        if n_devices > cards:
            row["backend"] = f"gloo, {n_devices} ranks on {cards} card" \
                + ("s" if cards > 1 else "")
            row["note"] = SHARED_NOTE
    return row


def scaling_sweep(problem: str = "rosenbrock", d: int = 1 << 22,
                  iters: int = 50, cfg: Optional[LBFGSConfig] = None,
                  device_counts: Optional[Sequence[int]] = None,
                  dtype: str = "float32", use_pallas: Optional[bool] = None,
                  with_matvec: bool = False, device=None,
                  repeats: int = 3) -> list[dict]:
    """Strong-scaling sweep over rank counts (default: 1, 2, 4, ... up to
    the cards present, on the CPU 1 and 2), each row with its ``speedup``
    and ``efficiency`` against the first count; ``scaling`` is False where
    any row's ranks shared a card, whose efficiency then measures the
    sharing."""
    cfg = cfg or LBFGSConfig(line_search="backtracking",
                             direction="compact_incremental",
                             ls_eval="polynomial")
    dev = resolve_device(device)
    if device_counts is None:
        most = torch.cuda.device_count() if dev.type == "cuda" else 2
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= most]
    rows = []
    base_rate = base_n = None
    for c in device_counts:
        r = bench_sharded(problem, d, iters, cfg, c, dtype, repeats,
                          use_pallas=use_pallas, with_matvec=with_matvec,
                          device=device)
        if base_rate is None:
            base_rate, base_n = r["iters_per_s"], c
        r["speedup"] = r["iters_per_s"] / base_rate
        r["efficiency"] = r["speedup"] / (c / base_n)
        rows.append(r)
    shared = any("note" in r for r in rows)
    for r in rows:
        r["scaling"] = not shared and dev.type == "cuda"
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tpu_lbfgs_torch.bench.scaling",
        description="strong scaling of the sharded solve")
    ap.add_argument("--problem", default="rosenbrock")
    ap.add_argument("--d", type=int, default=1 << 22)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--counts", type=int, nargs="+", default=None)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--plain", action="store_true",
                    help="the plain shard-local path, not the kernels")
    ap.add_argument("--matvec", action="store_true",
                    help="the history products in the fused tail")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="default", choices=["default", "cpu"])
    args = ap.parse_args(argv)
    rows = scaling_sweep(args.problem, args.d, args.iters,
                         device_counts=args.counts, dtype=args.dtype,
                         use_pallas=False if args.plain else None,
                         with_matvec=args.matvec,
                         device="cpu" if args.device == "cpu" else None,
                         repeats=args.repeats)
    for r in rows:
        print(json.dumps(r))
    if not rows[0]["scaling"]:
        print("# " + (SHARED_NOTE if any("note" in r for r in rows)
                      else "on the CPU: not a device number"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
