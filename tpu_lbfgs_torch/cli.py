"""The command line: problem, dimension, strategy, dtype, with the
argparse surface, the per-seed record and the ``--json`` document of
``tpu_lbfgs/cli.py``, so one argument list means the same solve in both
packages.

Examples:
  python -m tpu_lbfgs_torch --problem rosenbrock --dim 100000 --line-search wolfe_interpolation
  python -m tpu_lbfgs_torch --problem rosenbrock --dim 1048576 --dtype float32 --direction compact --pallas
  python -m tpu_lbfgs_torch --problem coupled_quadratic --dim 1048576 --pallas --poly-ls --direction compact_incremental
  python -m tpu_lbfgs_torch --batch 4096 --dim 1000 --max-iters 500 --poly-ls
  python -m tpu_lbfgs_torch --backend native --dim 10000        # C++ CPU oracle
  python -m tpu_lbfgs_torch --seeds 42 365 12345 777777 10000   # reference protocol
  torchrun --nproc-per-node=4 -m tpu_lbfgs_torch --problem rosenbrock --dim 4194304 --pallas --poly-ls --direction compact_incremental --shard

It solves on the current CUDA device and raises without one; ``--device
cpu`` asks for the CPU.  x0 is drawn with numpy's ``default_rng(seed)`` as
the reference draws it, so both command lines start from the same point.
``--pallas`` hands the solver the CUDA kernels of the problem
(``problems.suite``: the fused value-and-gradient, the fused tail and, for
the speculative searches in direct mode, the K-trial evaluators).  They
are float32 programs: with ``--dtype float64`` the command line warns and
hands the solver their plain versions, on either device
(``problems.suite.resolve_use_pallas``, the reference's ``pallas_ok``).

``--shard`` splits the vector axis over the processes of the job
(``dist.sharded_minimize``): launch one process per shard, with
``torchrun`` or after ``dist.initialize``, or give ``--nproc N`` and the
command starts its N ranks itself (``dist.launch.spawn_ranks``), as the
reference's one-process ``--shard`` needs no launcher; every process
draws the same x0 and takes its block, and rank 0 prints the record.  A
single process is a mesh of one shard.  With ``--device cpu`` the group is
gloo; on the card it is nccl, one device per process (``LOCAL_RANK``), or
under ``--nproc`` gloo where the ranks outnumber the cards and share them.

``--debug-nans`` checks the solver's state after every iteration and
each output of the objective's callables as it returns, and raises
``FloatingPointError`` at the first non-finite field or NaN output
(``core.solver.set_debug_nans``), where the reference sets
``jax_debug_nans``; a host read each, on every path.

``--batch`` runs through ``vmap_minimize``: every ``--line-search``, with
or without ``--poly-ls``, in either ``--lockstep``, with the problem's
plain f and gradient, as the reference's does.  ``--batch --pallas`` sets
``cfg.use_pallas`` as the reference's does: each iteration's tail is then
the batched ``iteration_tail`` kernel on the card, one launch over all
lanes, in float32 or float64 (that kernel is built for both, so
``--dtype float64`` takes no plain version here).  ``--shard`` with
``--batch`` runs the batch branch and ignores ``--shard`` there, as the
reference's command line does (its batch branch comes first); under a
launcher each rank solves the whole batch and rank 0 prints the record.

``--backend native`` solves each seed with the C++ oracle
(``tpu_lbfgs_torch.native``) in float64 on the host from the same
``default_rng(seed)`` draw, as the reference's does: the problems and line
searches it has (others exit through the parser first), the configuration's
line search, fidelity and constants, its own two-loop direction.  It runs
on the host whatever ``--device`` says, touches no CUDA device, and
ignores the flags of the other paths (``--batch``, ``--shard``,
``--pallas``, ``--dtype``, ...).
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    from .config import LINE_SEARCH_METHODS

    ap = argparse.ArgumentParser(
        prog="tpu_lbfgs_torch",
        description="L-BFGS solver in PyTorch and CUDA (the port of "
                    "tpu_lbfgs; reference: ndzajic1/cuda-lbfgs)")
    ap.add_argument("--problem", default="rosenbrock",
                    help="rosenbrock | quadratic | coupled_quadratic | sphere")
    ap.add_argument("--dim", type=int, default=100_000)
    ap.add_argument("--line-search", default="backtracking",
                    choices=list(LINE_SEARCH_METHODS))
    ap.add_argument("--direction", default="compact",
                    choices=["two_loop", "compact", "compact_incremental"])
    ap.add_argument("--fidelity", default="reference",
                    choices=["reference", "fixed"])
    ap.add_argument("-m", "--history", type=int, default=10)
    ap.add_argument("--max-iters", type=int, default=1000)
    ap.add_argument("--tol", type=float, default=1e-5)
    ap.add_argument("--c1", type=float, default=1e-4)
    ap.add_argument("--c2", type=float, default=0.9)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--damping", type=float, default=None,
                    help="Powell damping threshold (e.g. 0.2): blend "
                         "low-curvature pairs instead of rejecting them "
                         "(composes with every stack incl. --pallas)")
    ap.add_argument("--auto-speculative", action="store_true",
                    help="for the Wolfe searches: run a short probe solve, "
                         "then switch to the speculative (fused K-trial) "
                         "twin exactly when the observed line-search "
                         "trials/iteration crosses the boundary "
                         "(linesearch.resolve_speculative_auto)")
    ap.add_argument("--history-dtype", default=None,
                    choices=[None, "bfloat16", "float32", "auto"],
                    help="store the (m, d) history ring in this dtype "
                         "(bfloat16 halves its bytes; slightly approximate "
                         "H); 'auto' = core.solver.resolve_history_dtype")
    ap.add_argument("--pallas", action="store_true",
                    help="enable the fused CUDA kernels (f32 only)")
    ap.add_argument("--poly-ls", action="store_true",
                    help="polynomial directional line search: phi(alpha) in "
                         "closed form, O(1) scalar trials, no in-search "
                         "gradient evals")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42],
                    help="x0 seeds; reference protocol: 42 365 12345 777777 "
                         "10000")
    ap.add_argument("--x0-range", type=float, default=2.0,
                    help="x0 ~ U(-r, r); the reference's main.cpp uses 1000")
    ap.add_argument("--batch", type=int, default=0,
                    help="solve N independent instances in lockstep "
                         "(0 = single)")
    ap.add_argument("--lockstep", default="while",
                    choices=["while", "bounded"],
                    help="batch loop mode: 'while' freezes lanes as they "
                         "finish; 'bounded' runs the full --max-iters budget "
                         "with no read of the loop condition")
    ap.add_argument("--shard", action="store_true",
                    help="shard the vector axis over the job's processes "
                         "(launch with torchrun, one process per shard, or "
                         "give --nproc)")
    ap.add_argument("--nproc", type=int, default=0,
                    help="with --shard: start this many ranks from this "
                         "command (no launcher needed)")
    ap.add_argument("--backend", default="torch", choices=["torch", "native"],
                    help="native = the C++ CPU oracle")
    ap.add_argument("--trace", action="store_true",
                    help="record per-iteration metrics")
    ap.add_argument("--verbose", action="store_true",
                    help="print the reference-style per-iteration log "
                         "(Iteration k, f, |grad|) from the recorded trace, "
                         "read out once after the solve")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="record a torch.profiler trace of the (post-warmup) "
                         "solve into DIR (Chrome / Perfetto trace.json)")
    ap.add_argument("--device", default="default", choices=["default", "cpu"],
                    help="default is the current CUDA device; cpu asks for "
                         "the CPU")
    ap.add_argument("--debug-nans", action="store_true",
                    help="check the solver state after every iteration "
                         "and the objective's outputs as they return; raise "
                         "FloatingPointError at the first non-finite value "
                         "(a host read each)")
    return ap


def _rank_main(rank: int, size: int, argv: list) -> int:
    """One rank of ``--shard --nproc N``: the command line inside the group
    ``dist.launch.spawn_ranks`` made."""
    return main(argv)


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.nproc and not args.shard:
        ap.error("--nproc starts the ranks of --shard; give --shard too")
    if args.backend == "native":
        # Validate against what the C++ oracle supports before running.
        from .native.binding import _LS_IDS, PROBLEM_IDS
        if args.problem not in PROBLEM_IDS:
            ap.error(f"--backend native supports problems "
                     f"{sorted(PROBLEM_IDS)}, not {args.problem!r}")
        if args.line_search not in _LS_IDS:
            ap.error(f"--backend native supports line searches "
                     f"{sorted(_LS_IDS)}, not {args.line_search!r}")
        return _run_native(args)
    if args.nproc > 1:
        return _spawn(args, sys.argv[1:] if argv is None else list(argv))

    from .core.solver import set_debug_nans

    set_debug_nans(args.debug_nans)
    try:
        return _run(args)
    finally:
        set_debug_nans(False)


def _spawn(args, argv: list) -> int:
    """``--shard --nproc N``: N ranks of this command line on this host,
    gloo on the CPU or where the ranks outnumber the cards (they share
    them), else nccl with a card per rank."""
    import torch

    from .dist.launch import spawn_ranks

    cards = torch.cuda.device_count() if args.device != "cpu" else 0
    backend = "nccl" if 0 < args.nproc <= cards else "gloo"
    # Each rank runs the same command line; the last --nproc is the one
    # argparse keeps.
    codes = spawn_ranks(_rank_main, args.nproc, list(argv) + ["--nproc=0"],
                        backend=backend, timeout_s=600.0, threads=None)
    return max(codes)


def _config(args, record_trace: bool):
    from .config import LBFGSConfig

    return LBFGSConfig(
        m=args.history, max_iters=args.max_iters, tol=args.tol,
        line_search=args.line_search, direction=args.direction,
        fidelity=args.fidelity, c1=args.c1, c2=args.c2,
        use_pallas=args.pallas, record_trace=record_trace,
        ls_eval="polynomial" if args.poly_ls else "direct",
        history_dtype=args.history_dtype, damping=args.damping)


def _say(args, rec) -> None:
    if not args.json:
        print(f"seed {rec['seed']}: " + "  ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items() if k != "seed"))


def _summary(args, results) -> int:
    import numpy as np

    if args.json:
        print(json.dumps({"config": vars(args), "results": results}))
    elif len(results) > 1:
        walls = [r["wall_s"] for r in results]
        print(f"mean wall over {len(results)} seeds: {np.mean(walls):.4f}s "
              f"(protocol: cuda_lbfgs.pdf §IV, 5-run average)")
    return 0


def _run_native(args) -> int:
    """``--backend native``: each seed by the C++ oracle on the host."""
    import numpy as np

    from .native import native_lbfgs

    cfg = _config(args, record_trace=args.trace)
    results = []
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        x0 = rng.uniform(-args.x0_range, args.x0_range, args.dim)
        r = native_lbfgs(args.problem, x0, cfg)
        wall = time.perf_counter() - t0
        rec = {"seed": seed, "status": r["status"],
               "iterations": r["iterations"], "f": r["f"],
               "g_norm": r["g_norm"], "n_fev": r["n_fev"],
               "n_gev": r["n_gev"], "wall_s": wall}
        results.append(rec)
        _say(args, rec)
    return _summary(args, results)


def _run(args) -> int:
    import numpy as np
    import torch

    from . import Status, get_problem, minimize
    from .core.solver import resolve_history_dtype
    from .problems.suite import (
        fused_tail_for,
        fused_value_and_grad,
        multi_phi_dphi_for,
        multi_phi_for,
        resolve_use_pallas,
    )
    from .types import Guard, resolve_device

    mesh, own_group = None, False
    if args.shard:
        import os

        import torch.distributed

        from .dist import initialize, make_mesh

        # A group this call brings up is taken down before it returns.
        own_group = not torch.distributed.is_initialized()
        on_cpu = args.device == "cpu"
        if own_group and not on_cpu and torch.cuda.is_available():
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0))
                                  % torch.cuda.device_count())
        initialize(backend="gloo" if on_cpu else None)
        mesh = make_mesh()
    device = resolve_device("cpu" if args.device == "cpu" else None)
    # --verbose replays the trace, which only the single-instance branch
    # prints.
    cfg = _config(args, args.trace or (args.verbose and not args.batch))
    dtype = torch.float32 if args.dtype == "float32" else torch.float64
    p = get_problem(args.problem)

    def draw(rng, shape):
        return torch.from_numpy(rng.uniform(
            -args.x0_range, args.x0_range, shape)).to(device, dtype)

    dir_poly = p.dir_poly if args.poly_ls else None
    if args.auto_speculative:
        from .linesearch.strategies import (
            SPECULATIVE_TWINS,
            resolve_speculative_auto,
        )

        if cfg.line_search in SPECULATIVE_TWINS:
            # A short sequential probe from the first seed's start; its
            # trials per iteration decide the twin.
            x0p = draw(np.random.default_rng(args.seeds[0]), args.dim)
            probe_cfg = cfg.replace(max_iters=min(50, cfg.max_iters),
                                    record_trace=False)
            probe = minimize(p.f, x0p, probe_cfg, grad=p.grad,
                             dir_poly=dir_poly)
            cfg = resolve_speculative_auto(cfg, probe)
            print(f"# auto-speculative probe: "
                  f"{int(probe.n_fev) / max(int(probe.iterations), 1) - 1:.1f}"
                  f" trials/iter -> line_search={cfg.line_search}",
                  file=sys.stderr)
        else:
            print(f"# auto-speculative: no speculative twin for "
                  f"{cfg.line_search!r}; ignoring", file=sys.stderr)

    vg = fused_tail = phi_batch = phi_dphi_batch = None
    if args.pallas and not args.batch and not args.shard:
        kernels = resolve_use_pallas(True, dtype, "--pallas")
        vg = fused_value_and_grad(args.problem, use_pallas=kernels)
        fused_tail = fused_tail_for(
            args.problem, with_matvec="auto", use_pallas=kernels,
            m=cfg.m, d=args.dim,
            history_dtype=resolve_history_dtype(
                cfg.history_dtype, cfg.m, args.dim, dtype),
            accurate_dots=cfg.accurate_dots)
        if cfg.ls_eval == "direct":
            if cfg.line_search == "backtracking_speculative":
                phi_batch = multi_phi_for(args.problem, use_pallas=kernels)
            if cfg.line_search in ("wolfe_interpolation_speculative",
                                   "backtracking_wolfe_speculative"):
                phi_dphi_batch = multi_phi_dphi_for(args.problem,
                                                    use_pallas=kernels)

    results = []
    for seed in args.seeds:
        rng = np.random.default_rng(seed)
        t0 = time.perf_counter()
        if args.batch:
            from .batch import vmap_minimize
            x0s = draw(rng, (args.batch, args.dim))
            res = vmap_minimize(p.f, x0s, cfg, grad=p.grad, dir_poly=dir_poly,
                                lockstep=args.lockstep)
            st = res.status.cpu().numpy()
            wall = time.perf_counter() - t0
            rec = {"seed": seed, "batch": args.batch,
                   "converged": int((st == Status.CONVERGED).sum()),
                   "mean_iterations": float(res.iterations.double().mean()),
                   "mean_f": float(res.f.double().mean()),
                   "max_g_norm": float(res.g_norm.max()),
                   "wall_s": wall}
        else:
            x0 = draw(rng, args.dim)

            def solve():
                if args.shard:
                    from .dist import sharded_minimize
                    return sharded_minimize(p.f, x0, cfg, mesh=mesh,
                                            grad=p.grad, dir_poly=dir_poly,
                                            problem=args.problem)
                return minimize(p.f, x0, cfg, grad=None if vg else p.grad,
                                value_and_grad=vg, dir_poly=dir_poly,
                                fused_tail=fused_tail, phi_batch=phi_batch,
                                phi_dphi_batch=phi_dphi_batch)

            if args.profile:
                from .utils.profiling import profile_solve

                out = profile_solve(solve, trace_dir=args.profile,
                                    device=device)
                res, wall_profiled = out["result"], out["wall_s"]
            else:
                res = solve()
            f_final = float(res.f)      # waits for the device
            wall = wall_profiled if args.profile \
                else time.perf_counter() - t0
            if args.verbose and res.trace is not None \
                    and (mesh is None or mesh.rank == 0):
                k = int(res.iterations)
                tf = res.trace.f[:k].cpu().numpy()
                tg = res.trace.g_norm[:k].cpu().numpy()
                ta = res.trace.alpha[:k].cpu().numpy()
                tguards = res.trace.guards[:k].cpu().numpy()
                prev = np.zeros((Guard.N,), np.int64)
                for i in range(k):
                    line = (f"Iteration {i}, f = {tf[i]:.6g}, "
                            f"|grad| = {tg[i]:.6g}, alpha = {ta[i]:.4g}")
                    # The counters are cumulative: name what fired here.
                    fired = [Guard.NAMES[j] for j in range(Guard.N)
                             if tguards[i][j] > prev[j]]
                    prev = tguards[i]
                    if fired:
                        line += "  [" + ", ".join(fired) + "]"
                    print(line)
            rec = {"seed": seed, "status": Status.NAMES[int(res.status)],
                   "iterations": int(res.iterations), "f": f_final,
                   "g_norm": float(res.g_norm), "n_fev": int(res.n_fev),
                   "n_gev": int(res.n_gev), "wall_s": wall}
            g_arr = res.guards.cpu().numpy()
            rec["guards"] = {name: int(g_arr[j]) for j, name in
                             enumerate(Guard.NAMES) if int(g_arr[j])}
        results.append(rec)
        if mesh is None or mesh.rank == 0:
            _say(args, rec)     # replicated: rank 0 prints the record

    if own_group:
        from .dist import shutdown
        shutdown()
    if mesh is not None and mesh.rank != 0:
        return 0
    return _summary(args, results)


if __name__ == "__main__":
    sys.exit(main())
