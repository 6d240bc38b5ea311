"""Sharded solves: the parameter vector and the curvature history split
over the processes of a d-axis group (``tpu_lbfgs.dist.sharded``).

The reference writes its solver once on whole arrays and lets XLA's SPMD
partitioner turn every dot into a local partial and an all-reduce.  PyTorch
has no such partitioner for this code, so the port is explicit SPMD: every
process calls ``sharded_minimize`` with the same arguments, runs the
solver (``core.solver``, ``comm=``) on its own block of x, g and the
(m, d_local) ring, and finishes every reduction over d with an all-reduce
(``dist.comm``).  The compact direction's (2m, d) contraction crosses as
ONE packed (2m, m + 1) block per iteration, as in the reference.

Differences from the reference that follow from that design:

- ``res.x`` is this process's block of the zero-padded vector;
  ``gather_result`` assembles the unpadded whole on every rank.
- d is padded to a multiple of the group's size only (``mesh``).
- The objective is a suite problem, by name: the shard-local forms of its
  value, gradient and directional polynomial (``shardmap_vg``), or with
  ``cfg.use_pallas`` and a float32 x0 the shard-local CUDA kernels
  (``pallas_sharded``).  A caller's own objective would have to be
  shard-local too and is not taken on more than one shard.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch
from torch import Tensor

from ..config import LBFGSConfig
from ..core.solver import (
    init_state,
    make_value_and_grad,
    minimize,
    resolve_history_dtype,
    solve_to_result,
)
from ..kernels.fused_ops import pallas_ok
from ..types import SolveResult
from .mesh import Mesh, local_block, make_mesh, pad_for_mesh
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
                         dtype, with_matvec):
    """Resolve ``history_dtype="auto"`` and ``with_matvec="auto"`` on what
    one process holds, d_local = d_pad / n_shards: a shard's kernels stream
    its own (m, d_local) ring, so the port's measured rules
    (``resolve_history_dtype``, ``problems.suite.auto_with_matvec``) are
    asked about that, not about the global d.  Returns (cfg with a concrete
    history dtype, with_matvec as a bool)."""
    from ..problems.suite import auto_with_matvec

    d_local = d_pad // n_shards
    hdtype = resolve_history_dtype(cfg.history_dtype, cfg.m, d_local, dtype)
    cfg = cfg.replace(history_dtype=hdtype)
    if with_matvec == "auto":
        # t1 = S y and t2 = Y y are read only by the incremental direction.
        with_matvec = (cfg.direction == "compact_incremental"
                       and auto_with_matvec(cfg.m, d_local, hdtype))
    return cfg, bool(with_matvec)


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

    ``problem``: the suite problem's name, which selects the shard-local
    objective.  With ``cfg.use_pallas`` and a float32 x0 the solve runs the
    shard-local CUDA kernels (``pallas_sharded``); with ``cfg.use_pallas``
    but no such kernels (a problem without a kernel body, another dtype) it
    warns and runs the plain shard-local path, as the reference falls back
    to its auto-partitioned path.  On a mesh of more than one shard the
    objective must be a suite problem: ``f``, ``grad``, ``value_and_grad``
    and ``dir_poly`` are whole-vector callables and are used on a mesh of
    one shard only, where this is ``minimize``.  ``dir_poly`` not None asks
    for the problem's sharded polynomial under ``cfg.ls_eval="polynomial"``.

    ``with_matvec``: "auto" applies the port's rule to one shard's ring
    (``_resolve_shard_local``); True / False force the tail's in-kernel
    history products.  Only meaningful on the kernel path."""
    mesh = mesh if mesh is not None else make_mesh()
    n_shards = mesh.size
    if n_shards == 1:
        vg = make_value_and_grad(f, grad, value_and_grad)
        cfg, _ = _resolve_shard_local(cfg, x0.shape[-1], 1, x0.dtype, False)
        return minimize(f, x0, cfg, value_and_grad=vg, dir_poly=dir_poly)
    if problem not in CHUNKS:
        raise NotImplementedError(
            "sharded_minimize on more than one shard takes a suite problem "
            f"by name (problem= one of {sorted(CHUNKS)}): a caller's own "
            "objective would have to be shard-local and is not ported to "
            "tpu_lbfgs_torch yet (ROADMAP.md Queue 1 item 12, what is "
            "left)")
    if x0.dim() != 1:
        raise ValueError(f"x0 must be (d,), got {tuple(x0.shape)}")

    pallas_shard = (cfg.use_pallas and problem in SHARDED_PALLAS_PROBLEMS
                    and pallas_ok(x0.dtype))
    if cfg.use_pallas and not pallas_shard:
        warnings.warn(
            "sharded_minimize: use_pallas=True has no shard-composable "
            "kernels for this objective (pass problem=<a suite problem with "
            "a kernel body> with a float32 x0 to enable the shard-local "
            "kernel path); falling back to the plain shard-local path.",
            stacklevel=2)

    x0_pad, n = pad_for_mesh(x0, n_shards)
    cfg, wm = _resolve_shard_local(cfg, x0_pad.shape[-1], n_shards, x0.dtype,
                                   with_matvec if pallas_shard else False)
    return solve_shard(problem, local_block(x0_pad, mesh), n, cfg, mesh,
                       kernels=pallas_shard, with_matvec=wm)


def solve_shard(problem: str, x_local: Tensor, n: int, cfg: LBFGSConfig,
                mesh: Mesh, kernels: bool,
                with_matvec: bool = False) -> SolveResult:
    """This rank's part of the sharded solve from its block ``x_local`` of
    the zero-padded start, ``n`` the global unpadded length:
    ``sharded_minimize`` after its argument handling.  ``kernels`` selects
    the shard-local kernel path (``pallas_sharded``: the fused value and
    gradient, the fused tail, the K-trial evaluators of the speculative
    searches in direct mode) or the plain shard-local objective
    (``shardmap_vg``).  The kernel path's wrappers take any dtype on the
    CPU (their plain versions), which the tests use in float64."""
    fused_tail = phi_batch = phi_dphi_batch = None
    if kernels:
        vg = shardmap_fused_vg(problem, mesh, n)
        fused_tail = shardmap_fused_tail(problem, mesh, n,
                                         with_matvec=with_matvec,
                                         accurate_dots=cfg.accurate_dots)
        if cfg.ls_eval == "direct":
            if cfg.line_search == "backtracking_speculative":
                phi_batch = shardmap_multi_phi(problem, mesh, n)
            if cfg.line_search in ("wolfe_interpolation_speculative",
                                   "backtracking_wolfe_speculative"):
                phi_dphi_batch = shardmap_multi_phi_dphi(problem, mesh, n)
    else:
        vg = shardmap_value_and_grad(problem, mesh, n)
    # The shard-local kernels replace the objective and the tail; inside
    # the loop nothing else may launch a whole-vector kernel on a shard.
    cfg = cfg.replace(use_pallas=False)
    f_local = shardmap_value(problem, mesh, n)
    poly = shardmap_dir_poly(problem, mesh, n) \
        if cfg.ls_eval == "polynomial" else None

    comm = mesh.comm
    state = init_state(vg, x_local, cfg.m, cfg.history_dtype, comm=comm)
    return solve_to_result(cfg, f_local, vg, state, poly, fused_tail,
                           phi_batch, phi_dphi_batch, comm=comm)


def gather_result(res: SolveResult, mesh: Mesh, d: int) -> SolveResult:
    """The result with ``x`` as the whole unpadded (d,) vector, on every
    rank (one collective; the reference slices its global array instead)."""
    if mesh.comm is None:
        return res
    return res._replace(x=mesh.comm.all_gather_vec(res.x)[:d])
