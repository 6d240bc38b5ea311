"""Sharded solves: the parameter vector and the curvature history split
over the processes of a d-axis group, and a batch of instances split over
the rows of a 2-D ``(b, d)`` mesh (``tpu_lbfgs.dist.sharded``).

The reference writes its solver once on whole arrays and lets XLA's SPMD
partitioner turn every dot into a local partial and an all-reduce.  PyTorch
has no such partitioner for this code, so the port is explicit SPMD: every
process calls ``sharded_minimize`` with the same arguments, runs the
solver (``core.solver``, ``comm=``) on its own block of x, g and the
(m, d_local) ring, and finishes every reduction over d with an all-reduce
(``dist.comm``).  The compact direction's (2m, d) contraction crosses as
ONE packed (2m, m + 1) block per iteration, as in the reference.

Differences from the reference that follow from that design:

- ``res.x`` is this process's block of the zero-padded vector (for a
  batch, its row's lanes of that block, and the scalars its row's lanes);
  ``gather_result`` assembles the unpadded whole on every rank.
- d is padded to a multiple of the group's size only (``mesh``).
- A suite problem, by name, runs the shard-local forms of its value,
  gradient and directional polynomial (``shardmap_vg``), or with
  ``cfg.use_pallas`` and a float32 x0 the shard-local CUDA kernels
  (``pallas_sharded``).  A caller's own whole-vector objective runs on the
  DTensor of the rank's block (``partitioned``), which partitions it as
  XLA partitions the reference's.
- ``sharded_vmap_minimize`` is the same solver over a batched state: each
  rank holds its row's B / b lanes of its d block, every reduction over d
  finishes with one packed all-reduce over the rank's d group for all its
  lanes at once, and each row of the mesh loops until its own lanes end
  (a frozen lane is idempotent, so every lane's result is the one the
  reference's single vmapped loop gives).  The rows never communicate
  during the solve.
"""
from __future__ import annotations

import warnings
from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..core.solver import (
    _solve_traced,
    _state_to_result,
    init_state,
    make_value_and_grad,
    minimize,
    resolve_history_dtype,
    solve_bounded,
    solve_from_state,
)
from ..kernels.fused_ops import pallas_ok
from ..types import LBFGSState, SolveResult, Status
from .mesh import Mesh, local_block, local_lanes, make_mesh, pad_for_mesh
from .partitioned import (
    partitioned_dir_poly,
    partitioned_value,
    partitioned_value_and_grad,
)
from .pallas_sharded import (
    SHARDED_PALLAS_PROBLEMS,
    shardmap_fused_tail,
    shardmap_fused_vg,
    shardmap_multi_phi,
    shardmap_multi_phi_dphi,
)
from .shardmap_vg import (
    CHUNKS,
    shardmap_dir_poly,
    shardmap_value,
    shardmap_value_and_grad,
)


def _resolve_shard_local(cfg: LBFGSConfig, d_pad: int, n_shards: int,
                         dtype, with_matvec, batch_local: int = 1):
    """Resolve ``history_dtype="auto"`` and ``with_matvec="auto"`` on what
    one process holds, d_local = d_pad / n_shards times ``batch_local``
    lanes (a batch over the b rows of a 2-D mesh): a shard's kernels stream
    its own (batch_local, m, d_local) ring, so the port's measured rules
    (``resolve_history_dtype``, ``problems.suite.auto_with_matvec``) are
    asked about that, not about the global d.  Returns (cfg with a concrete
    history dtype, with_matvec as a bool)."""
    from ..problems.suite import auto_with_matvec

    d_local = d_pad // n_shards
    hdtype = resolve_history_dtype(cfg.history_dtype, cfg.m, d_local, dtype,
                                   batch=batch_local)
    cfg = cfg.replace(history_dtype=hdtype)
    if with_matvec == "auto":
        # t1 = S y and t2 = Y y are read only by the incremental direction.
        with_matvec = (cfg.direction == "compact_incremental"
                       and auto_with_matvec(cfg.m, d_local, hdtype,
                                            batch=batch_local))
    return cfg, bool(with_matvec)


def _pallas_shard(fn: str, cfg: LBFGSConfig, n_shards: int, problem, dtype):
    """The reference's rule for the shard-local kernel path: with
    ``cfg.use_pallas``, more than one shard, a problem with kernel bodies
    and a float32 iterate.  Returns (whether it is taken, cfg): where
    Pallas was asked for on several shards and cannot compose, a warning,
    and cfg without ``use_pallas``, for the plain shard-local path."""
    pallas_shard = (cfg.use_pallas and n_shards > 1
                    and problem in SHARDED_PALLAS_PROBLEMS
                    and pallas_ok(dtype))
    if n_shards > 1 and cfg.use_pallas and not pallas_shard:
        warnings.warn(
            f"{fn}: use_pallas=True has no shard-composable kernels for this "
            "objective (pass problem=<a suite problem with a kernel body> "
            "with a float32 x0 to enable the shard-local kernel path); "
            "falling back to the plain shard-local path.", stacklevel=3)
        cfg = cfg.replace(use_pallas=False)
    return pallas_shard, cfg


def sharded_minimize(f: Callable, x0: Tensor,
                     cfg: LBFGSConfig = LBFGSConfig(),
                     mesh: Optional[Mesh] = None, grad=None,
                     value_and_grad=None, dir_poly=None,
                     problem: Optional[str] = None,
                     with_matvec="auto") -> SolveResult:
    """Single-instance solve with x, g and the (m, d) history sharded on
    the vector axis over ``mesh`` (default: ``make_mesh()``, the default
    process group).  Every rank calls it with the same global ``x0`` (on
    the device it solves on) and takes its own block; a d that the mesh
    does not divide is zero-padded, which is exactly equivalent
    (``mesh.pad_for_mesh``).  The result's scalars are replicated and its
    ``x`` is this rank's block of the padded vector (``gather_result``).

    ``problem``: a suite problem's name selects its shard-local objective.
    With ``cfg.use_pallas`` and a float32 x0 the solve runs the
    shard-local CUDA kernels (``pallas_sharded``); with ``cfg.use_pallas``
    but no such kernels (no problem, a problem without a kernel body,
    another dtype) it warns and runs the plain path, as the reference falls
    back to its auto-partitioned path.  Without a suite problem ``f`` and
    the ``grad``, ``value_and_grad`` and ``dir_poly`` given are the
    caller's whole-vector callables, called on DTensors of the rank's
    block (``partitioned``; autograd's gradient without ``grad``), which
    never see the padding; on a mesh of one shard this is ``minimize``.
    ``dir_poly`` not None asks for the problem's sharded polynomial under
    ``cfg.ls_eval="polynomial"``.

    ``with_matvec``: "auto" applies the port's rule to one shard's ring
    (``_resolve_shard_local``); True / False force the tail's in-kernel
    history products.  Only meaningful on the kernel path."""
    mesh = mesh if mesh is not None else make_mesh()
    n_shards = mesh.size
    if n_shards == 1:
        vg = make_value_and_grad(f, grad, value_and_grad)
        cfg, _ = _resolve_shard_local(cfg, x0.shape[-1], 1, x0.dtype, False)
        return minimize(f, x0, cfg, value_and_grad=vg, dir_poly=dir_poly)
    if x0.dim() != 1:
        raise ValueError(f"x0 must be (d,), got {tuple(x0.shape)}")

    pallas_shard, cfg = _pallas_shard("sharded_minimize", cfg, n_shards,
                                      problem, x0.dtype)

    x0_pad, n = pad_for_mesh(x0, n_shards)
    cfg, wm = _resolve_shard_local(cfg, x0_pad.shape[-1], n_shards, x0.dtype,
                                   with_matvec if pallas_shard else False)
    return solve_shard(problem, local_block(x0_pad, mesh), n, cfg, mesh,
                       kernels=pallas_shard, with_matvec=wm, f=f, grad=grad,
                       value_and_grad=value_and_grad, dir_poly=dir_poly)


def sharded_vmap_minimize(f: Callable, x0_batch: Tensor,
                          cfg: LBFGSConfig = LBFGSConfig(),
                          mesh: Optional[Mesh] = None, grad=None,
                          value_and_grad=None, batch_axis: str = "b",
                          d_axis: str = "d", dir_poly=None,
                          problem: Optional[str] = None,
                          with_matvec="auto",
                          lockstep: str = "while") -> SolveResult:
    """Batched and sharded: the B instances of ``x0_batch`` (B, d) split
    over the b rows of a 2-D mesh (``make_mesh_2d``), each instance's
    vector over the row's d group.  Every rank calls it with the same
    global (B, d) ``x0_batch`` (on the device it solves on) and takes its
    row's B / b lanes of its d block, zero-padded as ``pad_for_mesh`` pads.
    The result holds those lanes: its ``x`` (B / b, d_local), its scalars
    (B / b,); ``gather_result`` assembles the unpadded (B, d) and the (B,)
    scalars on every rank.

    ``lockstep``: "while" (default) freezes lanes as they finish, and each
    row of the mesh reads its own loop condition; "bounded" runs every lane
    for ``cfg.max_iters`` with no read (``vmap_minimize``'s two modes).
    ``problem``, ``dir_poly``, ``with_matvec`` and the fallback with a
    warning where ``cfg.use_pallas`` cannot compose are
    ``sharded_minimize``'s, with the residency rules asked about the B / b
    lanes a rank holds; with the shard-local kernels every call of the
    fused value and gradient, the fused tail and the K-trial evaluators of
    the speculative searches launches the batched shard-local kernel once
    for all the rank's lanes.  A caller's own callables take the batch
    whole, as ``vmap_minimize``'s do: ``f`` gets the row's (B / b, d)
    lanes as a DTensor sharded on d and returns (B / b,).  On a mesh of
    one d shard a row solves its lanes with ``vmap_minimize`` and the
    caller's own callables.
    ``batch_axis`` and ``d_axis`` name the reference's mesh axes; the
    port's mesh knows its two axes by position and ignores them.

    Raises ``ValueError`` as the reference does: without a mesh, for a
    ``lockstep`` other than "while" or "bounded", and for "bounded" with
    ``cfg.record_trace``; also for a B that the mesh's rows do not divide
    (which the reference's device placement refuses)."""
    del batch_axis, d_axis
    if mesh is None:
        raise ValueError("sharded_vmap_minimize requires an explicit 2-D mesh "
                         "(make_mesh_2d)")
    if lockstep not in ("while", "bounded"):
        raise ValueError(f"lockstep must be 'while' or 'bounded', "
                         f"got {lockstep!r}")
    if lockstep == "bounded" and cfg.record_trace:
        raise ValueError("lockstep='bounded' is incompatible with "
                         "cfg.record_trace (the traced scan freezes "
                         "finished lanes); trace with lockstep='while'")
    if x0_batch.dim() != 2:
        raise ValueError(f"x0_batch must be (B, d), got "
                         f"{tuple(x0_batch.shape)}")
    if x0_batch.shape[0] % mesh.batch_size:
        raise ValueError(f"a batch of {x0_batch.shape[0]} instances does not "
                         f"divide over the mesh's {mesh.batch_size} rows")
    n_shards = mesh.size
    batch_local = x0_batch.shape[0] // mesh.batch_size
    x_rows = local_lanes(x0_batch, mesh)
    pallas_shard, cfg = _pallas_shard("sharded_vmap_minimize", cfg, n_shards,
                                      problem, x0_batch.dtype)
    if n_shards == 1:
        from ..batch.vmapped import vmap_minimize

        cfg, _ = _resolve_shard_local(cfg, x0_batch.shape[-1], 1,
                                      x0_batch.dtype, False, batch_local)
        return vmap_minimize(f, x_rows, cfg, grad=grad,
                             value_and_grad=value_and_grad,
                             dir_poly=dir_poly, lockstep=lockstep)
    x_pad, n = pad_for_mesh(x_rows, n_shards)
    cfg, wm = _resolve_shard_local(cfg, x_pad.shape[-1], n_shards,
                                   x0_batch.dtype,
                                   with_matvec if pallas_shard else False,
                                   batch_local)
    return solve_shard(problem, local_block(x_pad, mesh), n, cfg, mesh,
                       kernels=pallas_shard, with_matvec=wm,
                       bounded=lockstep == "bounded", f=f, grad=grad,
                       value_and_grad=value_and_grad, dir_poly=dir_poly)


class ShardObjective(NamedTuple):
    """The callables of one rank's solve, on its block (``f(x_local)``,
    ``vg(x_local)``, ``dir_poly(x_local, d_local)``, the fused tail and the
    K-trial evaluators), and ``cfg`` as the loop runs it."""
    cfg: LBFGSConfig
    f: Callable
    vg: Callable
    dir_poly: Optional[Callable] = None
    fused_tail: Optional[Callable] = None
    phi_batch: Optional[Callable] = None
    phi_dphi_batch: Optional[Callable] = None


def shard_objective(problem: Optional[str], n: int, cfg: LBFGSConfig,
                    mesh: Mesh, kernels: bool = False,
                    with_matvec: bool = False, f: Optional[Callable] = None,
                    grad=None, value_and_grad=None,
                    dir_poly=None) -> ShardObjective:
    """What a rank's solve runs, ``n`` the global unpadded length.

    A suite ``problem`` (by name): ``kernels`` selects the shard-local
    kernel path (``pallas_sharded``: the fused value and gradient, the
    fused tail, the K-trial evaluators of the speculative searches in
    direct mode) or the plain shard-local objective (``shardmap_vg``), and
    the problem's sharded polynomial serves ``ls_eval="polynomial"``.  The
    kernel path's wrappers take any dtype on the CPU (their plain
    versions), which the tests use in float64.  Otherwise ``f``, ``grad``,
    ``value_and_grad`` and ``dir_poly`` are the caller's whole-vector
    callables, partitioned by DTensor (``partitioned``); there is no
    kernel path for them.  On a mesh of one shard (no comm) the
    whole-vector forms run: the problem's kernels or callables, or the
    caller's."""
    if kernels and problem not in SHARDED_PALLAS_PROBLEMS:
        raise ValueError(f"no shard-local kernels for problem={problem!r} "
                         f"(one of {sorted(SHARDED_PALLAS_PROBLEMS)})")
    # The shard-local kernels replace the objective and the tail; inside
    # the loop nothing else may launch a whole-vector kernel on a shard.
    loop_cfg = cfg.replace(use_pallas=False)
    poly = cfg.ls_eval == "polynomial"
    if problem not in CHUNKS:
        if f is None:
            raise ValueError(f"problem={problem!r} is no suite problem "
                             f"({sorted(CHUNKS)}) and no f was given")
        if mesh.comm is None:
            return ShardObjective(loop_cfg, f, make_value_and_grad(
                f, grad, value_and_grad), dir_poly if poly else None)
        return ShardObjective(
            loop_cfg, partitioned_value(f, mesh, n),
            partitioned_value_and_grad(f, mesh, n, grad, value_and_grad),
            partitioned_dir_poly(dir_poly, mesh, n) if poly else None)
    if mesh.comm is None:
        # One shard: the problem's whole-vector forms and kernels.
        from ..problems import suite

        p = suite.get_problem(problem)
        plain = (p.f, p.value_and_grad, p.dir_poly)
        fused = (suite.fused_value_and_grad, suite.fused_tail_for,
                 suite.multi_phi_for, suite.multi_phi_dphi_for)
    else:
        plain = (shardmap_value(problem, mesh, n),
                 shardmap_value_and_grad(problem, mesh, n),
                 shardmap_dir_poly(problem, mesh, n))
        fused = tuple(
            lambda name, _k=k, **kw: _k(name, mesh, n, **kw)
            for k in (shardmap_fused_vg, shardmap_fused_tail,
                      shardmap_multi_phi, shardmap_multi_phi_dphi))
    obj = ShardObjective(loop_cfg, plain[0], plain[1],
                         plain[2] if poly else None)
    if not kernels:
        return obj
    vg, tail, phi, phi_dphi = fused
    speculative = cfg.ls_eval == "direct" and cfg.line_search in (
        "backtracking_speculative", "wolfe_interpolation_speculative",
        "backtracking_wolfe_speculative")
    armijo = cfg.line_search == "backtracking_speculative"
    return obj._replace(
        vg=vg(problem),
        fused_tail=tail(problem, with_matvec=with_matvec,
                        accurate_dots=cfg.accurate_dots),
        phi_batch=phi(problem) if speculative and armijo else None,
        phi_dphi_batch=phi_dphi(problem)
        if speculative and not armijo else None)


def solve_shard(problem: Optional[str], x_local: Tensor, n: int,
                cfg: LBFGSConfig, mesh: Mesh, kernels: bool,
                with_matvec: bool = False, bounded: bool = False,
                return_state: bool = False, **own):
    """This rank's part of the sharded solve from its block ``x_local`` of
    the zero-padded start, ``n`` the global unpadded length:
    ``sharded_minimize`` (a (d_local,) block) and ``sharded_vmap_minimize``
    (a row's (B / b, d_local) lanes) after their argument handling.
    ``problem``, ``kernels``, ``with_matvec`` and ``own`` (the caller's
    ``f``, ``grad``, ``value_and_grad``, ``dir_poly``) as in
    ``shard_objective``; ``bounded`` as in ``solve_shard_from_state``.
    Returns the ``SolveResult``, and with ``return_state`` also the
    rank's final state, which ``solve_shard_from_state`` and
    ``io.save_state_sharded`` take."""
    obj = shard_objective(problem, n, cfg, mesh, kernels, with_matvec, **own)
    state = init_state(obj.vg, x_local, cfg.m, cfg.history_dtype,
                       comm=mesh.comm)
    res, state = _solve(obj, state, mesh, bounded)
    return (res, state) if return_state else res


def solve_shard_from_state(state: LBFGSState, n: int, cfg: LBFGSConfig,
                           mesh: Mesh, problem: Optional[str] = None,
                           kernels: bool = False, with_matvec: bool = False,
                           bounded: bool = False,
                           **own) -> tuple[SolveResult, LBFGSState]:
    """The state-in / state-out form of the sharded solve: from this rank's
    ``state`` (its block of x, g and the ring, the replicated scalars; as
    ``solve_shard(..., return_state=True)`` or ``io.load_state_sharded``
    give it) on ``mesh``, the objective as in ``shard_objective``, while
    ``state.k < cfg.max_iters`` and the solve runs.  ``bounded``:
    ``solve_bounded``, ``cfg.max_iters`` more iterations with no read,
    else ``solve_from_state`` (or the traced solve).  Returns this rank's
    ``SolveResult`` and final state.  The ring is updated in place: the
    state handed in must not be used again."""
    obj = shard_objective(problem, n, cfg, mesh, kernels, with_matvec, **own)
    return _solve(obj, state, mesh, bounded)


def _solve(obj: ShardObjective, state: LBFGSState, mesh: Mesh,
           bounded: bool) -> tuple[SolveResult, LBFGSState]:
    args = (obj.cfg, obj.f, obj.vg, state, obj.dir_poly, obj.fused_tail,
            obj.phi_batch, obj.phi_dphi_batch, mesh.comm)
    trace = None
    if bounded:
        state = solve_bounded(*args)
    elif obj.cfg.record_trace:
        state, trace = _solve_traced(*args)
    else:
        state = solve_from_state(*args)
    # The state goes on: a solve that its cap stopped is RUNNING again, as
    # ``make_solve_segment`` leaves it, so a later cap resumes it.
    status = torch.where(state.status == Status.MAX_ITERS, Status.RUNNING,
                         state.status).to(state.status.dtype)
    return _state_to_result(state, trace), state.replace(status=status)


def _gather_lanes(t: Tensor, mesh: Mesh) -> Tensor:
    """(B, ...) on every rank from each row's (B / b, ...) lanes, which are
    the same on every rank of the row: the mesh's blocks gathered, one
    rank of each row kept."""
    rows = mesh.grid.all_gather_vec(t.unsqueeze(0))[::mesh.size]
    return rows.reshape((-1,) + tuple(t.shape[1:]))


def gather_result(res: SolveResult, mesh: Mesh, d: int,
                  with_x: bool = True) -> SolveResult:
    """The result with ``x`` as the whole unpadded (d,) vector, on every
    rank (one collective; the reference slices its global array instead).
    A batch's result from ``sharded_vmap_minimize`` becomes the (B, d)
    ``x`` and every other field's (B, ...), on every rank of the 2-D
    mesh.  ``with_x=False`` leaves ``x`` the rank's block and gathers the
    rest only."""
    if res.x.dim() == 1:
        # One instance, over the rank's d group.
        if mesh.comm is None or not with_x:
            return res
        return res._replace(x=mesh.comm.all_gather_vec(res.x)[:d])
    if mesh.grid is None:
        return res
    out = {}
    x = res.x
    if with_x:
        # The mesh's (B / b, d_local) blocks, row-major (b, d): each row's
        # lanes with their d blocks side by side.
        blocks = mesh.grid.all_gather_vec(x.unsqueeze(0)).reshape(
            mesh.batch_size, mesh.size, x.shape[0], x.shape[-1])
        out["x"] = blocks.permute(0, 2, 1, 3).reshape(
            -1, mesh.size * x.shape[-1])[:, :d]
    if mesh.batch_size > 1:
        for name in ("f", "g_norm", "iterations", "status", "n_fev", "n_gev",
                     "guards"):
            out[name] = _gather_lanes(getattr(res, name), mesh)
        if res.trace is not None:
            out["trace"] = type(res.trace)(*(_gather_lanes(t, mesh)
                                             for t in res.trace))
    return res._replace(**out)
