"""Run a function as the ranks of one sharded job on this host: what
``torchrun`` does for a script, for a function, with the ranks' return
values handed back.  The tests run their 4-rank CPU jobs through it, and
``chip_smoke.py`` its ranks on the card.

The ranks are started with ``spawn`` (the parent may hold a CUDA context,
which a fork would break) and joined to one group through a ``FileStore``
in the job's own temporary directory (``file://``): no port is chosen
before a rank binds it, so jobs started at once on one host cannot take
each other's rendezvous.  A rank that raises ends the job and the other
ranks are terminated; a rank blocked in a collective after a peer died
ends by the group's timeout.  Each rank that raises writes its error
beside its result, with the time it raised, and the parent raises the
error of the rank that raised first: the rank whose own code failed, not
a peer whose collective broke when it went (whichever process exit the
parent happens to see first).

A rank also writes a marker of how far it got (``MARKS``: after
``initialize``, after ``fn`` returned, after ``shutdown``), so that a rank
that ends by a signal, where it can write no error, is named with the
signal and the last point it reached.
"""
from __future__ import annotations

import os
import pickle
import signal
import socket
import tempfile
import time
import traceback
from typing import Callable, Optional


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


#: The points a rank marks, in order.
MARKS = ("after initialize", "after fn", "after shutdown")


def _mark(out_dir: str, rank: int, where: str) -> None:
    with open(os.path.join(out_dir, f"rank{rank}.at"), "w") as fh:
        fh.write(where)


def last_mark(out_dir: str, rank: int) -> str:
    """The last of ``MARKS`` that ``rank`` wrote into ``out_dir``, or
    "before initialize"."""
    try:
        with open(os.path.join(out_dir, f"rank{rank}.at")) as fh:
            return fh.read()
    except FileNotFoundError:
        return "before initialize"


def _rank_main(rank: int, fn: Callable, size: int, init: str,
               backend: Optional[str],
               timeout_s: float, threads: Optional[int], out_dir: str,
               args: tuple) -> None:
    import torch

    from .multihost import initialize, shutdown

    if threads:
        torch.set_num_threads(threads)
    if torch.cuda.is_available():
        # One card per rank where the host has them; ranks beyond that
        # share (which nccl refuses: pass backend="gloo").
        torch.cuda.set_device(rank % torch.cuda.device_count())
    try:
        initialize(init, size, rank, backend=backend, timeout_s=timeout_s)
        _mark(out_dir, rank, MARKS[0])
        out = fn(rank, size, *args)
    except BaseException as e:
        err = {"rank": rank, "time": time.time(),
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
        with open(os.path.join(out_dir, f"rank{rank}.err"), "wb") as fh:
            pickle.dump(err, fh)
        raise
    _mark(out_dir, rank, MARKS[1])
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    shutdown()
    _mark(out_dir, rank, MARKS[2])


def first_error(out_dir: str) -> Optional[dict]:
    """The error that the earliest failing rank wrote into ``out_dir``
    (``rank``, ``time``, ``error``, ``traceback``), or None."""
    errs = []
    for name in os.listdir(out_dir):
        if name.endswith(".err"):
            with open(os.path.join(out_dir, name), "rb") as fh:
                errs.append(pickle.load(fh))
    return min(errs, key=lambda e: (e["time"], e["rank"])) if errs else None


def _ending(exitcode: int) -> str:
    if exitcode < 0:
        try:
            return f"terminated with signal {signal.Signals(-exitcode).name}"
        except ValueError:
            return f"terminated with signal {-exitcode}"
    return f"exited with code {exitcode}"


def _failure(processes: list, out_dir: str, error: Exception
             ) -> Optional[str]:
    """What ``spawn_ranks`` raises when a rank failed: each rank that
    ended without an error of its own (by a signal, or ``os._exit``), with
    its last mark, then the error of the rank that raised first; None
    when neither is known.  The ranks that the parent terminated after the
    first failure (SIGTERM) are left out."""
    import torch.multiprocessing as mp

    ended = [r for r, p in enumerate(processes)
             if p.exitcode not in (0, -signal.SIGTERM)
             and not os.path.exists(os.path.join(out_dir, f"rank{r}.err"))]
    if (isinstance(error, mp.ProcessExitedException)
            and error.error_index not in ended):
        ended.insert(0, error.error_index)
    lines = [f"rank {r} {_ending(processes[r].exitcode)}; its last mark: "
             f"{last_mark(out_dir, r)}" for r in ended]
    first = first_error(out_dir)
    if first is not None:
        lines.append(f"rank {first['rank']} failed first: {first['error']}\n"
                     f"{first['traceback']}")
    return "\n".join(lines) or None


def spawn_ranks(fn: Callable, size: int, *args,
                backend: Optional[str] = None, timeout_s: float = 120.0,
                threads: Optional[int] = 1) -> list:
    """``fn(rank, size, *args)`` on ``size`` spawned processes joined to
    one ``backend`` group (default: ``multihost.initialize``'s, nccl where
    a CUDA device is present, else gloo); returns the ranks' return values
    in rank order (they must pickle).  ``fn`` must be importable from the children (a
    module-level function).  ``threads`` caps each rank's intra-op threads
    (None leaves PyTorch's default).  When a rank fails, a
    ``RuntimeError`` names each rank that ended by a signal or an exit
    code with the last of ``MARKS`` it reached, and the rank that raised
    first with its error and traceback (``first_error``)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as out_dir:
        init = "file://" + os.path.join(out_dir, "rendezvous")
        ctx = mp.start_processes(
            _rank_main, args=(fn, size, init, backend, timeout_s, threads,
                              out_dir, args),
            nprocs=size, join=False, start_method="spawn")
        try:
            while not ctx.join():
                pass
        except Exception as e:
            why = _failure(ctx.processes, out_dir, e)
            if why is None:
                raise
            raise RuntimeError(why) from e
        outs = []
        for rank in range(size):
            with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as fh:
                outs.append(pickle.load(fh))
    return outs


def solve_cases(rank: int, size: int, cases: list, device=None):
    """A rank function for ``spawn_ranks``: each case, a dict, through the
    sharded solve on ``device`` (default: the current CUDA device, and it
    raises without one; ``"cpu"`` asks for the CPU, as the tests do, over a
    gloo group), and per case a dict of plain Python and
    numpy values (the trace, the status, the gathered x, this rank's kernel
    launches, all-reduces and edge exchanges, set to 0 just before the
    solve and read just after, and its seconds).

    A case: ``problem``, ``d``, ``dtype`` (a torch dtype's name), ``seed``
    and ``box`` (x0 ~ U(-box, box) drawn with numpy in float64, as the
    command line draws it), ``cfg`` (``LBFGSConfig`` keywords), ``kw``
    (``sharded_minimize`` keywords), and optionally ``kernels``: True or
    False calls ``solve_shard`` with that path whatever the dtype, where
    ``sharded_minimize`` chooses by ``cfg.use_pallas`` and a float32 x0.

    A case with a ``batch_size`` key is a batch on the 2-D mesh
    ``make_mesh_2d(batch_size)`` (made once per row count and kept for the
    later cases): ``batch`` instances, x0 (batch, d), through
    ``sharded_vmap_minimize`` with ``lockstep`` (default "while"), or with
    ``kernels`` set through ``solve_shard`` on the rank's lanes; its
    scalars, trace and x come back gathered, (batch, ...), and its
    all-reduces and edge exchanges are those of the rank's d group."""
    import time
    import warnings

    import numpy as np
    import torch

    from .. import LBFGSConfig, get_problem, kernels
    from ..types import resolve_device
    from .mesh import (
        local_block,
        local_lanes,
        make_mesh,
        make_mesh_2d,
        pad_for_mesh,
    )
    from .sharded import (
        gather_result,
        sharded_minimize,
        sharded_vmap_minimize,
        solve_shard,
    )

    meshes = {None: make_mesh()}    # by row count; None: the 1-D mesh
    dev = resolve_device(device)
    outs = []
    for case in cases:
        rows = case.get("batch_size")
        batched = rows is not None
        if rows not in meshes:
            meshes[rows] = make_mesh_2d(rows)
        mesh = meshes[rows]
        p = get_problem(case["problem"])
        cfg = LBFGSConfig(**case["cfg"])
        rng = np.random.default_rng(case.get("seed", 0))
        box = case.get("box", 2.0)
        shape = (case["batch"], case["d"]) if batched else case["d"]
        x0 = torch.from_numpy(rng.uniform(-box, box, shape)).to(
            dev, getattr(torch, case["dtype"]))
        lockstep = case.get("lockstep", "while")
        kernels.reset_launches()
        if mesh.comm is not None:
            mesh.comm.reset_counts()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if case.get("kernels") is None and batched:
                res = sharded_vmap_minimize(p.f, x0, cfg, mesh,
                                            grad=p.grad,
                                            problem=case["problem"],
                                            dir_poly=p.dir_poly,
                                            lockstep=lockstep,
                                            **case.get("kw", {}))
            elif case.get("kernels") is None:
                res = sharded_minimize(p.f, x0, cfg, mesh,
                                       problem=case["problem"],
                                       dir_poly=p.dir_poly,
                                       **case.get("kw", {}))
            else:
                rows_x0 = local_lanes(x0, mesh) if batched else x0
                x0_pad, n = pad_for_mesh(rows_x0, mesh.size)
                res = solve_shard(case["problem"], local_block(x0_pad, mesh),
                                  n, cfg, mesh, kernels=case["kernels"],
                                  bounded=lockstep == "bounded",
                                  **case.get("kw", {}))
        res.f.sum().item()           # waits for the device
        wall = time.perf_counter() - t0
        whole = gather_result(res, mesh, case["d"],
                              with_x=case.get("gather", True))
        out = {"wall_s": wall,
               "launches": {k: v for k, v in kernels.launch_counts().items()
                            if v},
               "all_reduces": mesh.comm.all_reduces if mesh.comm else 0,
               "edge_exchanges": (mesh.comm.edge_exchanges if mesh.comm
                                  else 0),
               "warnings": [str(w.message) for w in caught],
               "x_local_shape": tuple(res.x.shape),
               "x_local_finite": bool(torch.isfinite(res.x).all()),
               "x": whole.x.cpu().numpy()
               if case.get("gather", True) else None}
        if batched:
            out.update({name: getattr(whole, name).cpu().numpy()
                        for name in ("f", "g_norm", "status", "iterations",
                                     "n_fev", "n_gev", "guards")})
        else:
            out.update({"f": res.f.item(), "g_norm": res.g_norm.item(),
                        "status": int(res.status),
                        "iterations": int(res.iterations),
                        "n_fev": int(res.n_fev), "n_gev": int(res.n_gev),
                        "guards": res.guards.tolist()})
        if whole.trace is not None:
            out["trace"] = {name: getattr(whole.trace, name).cpu().numpy()
                            for name in whole.trace._fields}
        outs.append(out)
    return outs
