"""The fused CUDA kernels composed with sharding
(``tpu_lbfgs.dist.pallas_sharded``): each rank runs the shard-local form of
a kernel on its block, the neighbours' boundary elements come from one edge
exchange, and every sum is finished by ONE packed float64 all-reduce.

Each kernel takes three inputs beyond its whole-vector form
(``kernels.fused_ops.local_fused_vg`` / ``local_fused_tail``,
``kernels.line_search_ops.local_multi_phi`` / ``local_multi_phi_dphi``):

  ``start``   the shard's global element offset, rank * d_local, so that
              term ownership and the zero-padded tail go by global index;
  ``edges``   the neighbouring shards' boundary elements of x (and d for the
              kernels that form trial points), a device tensor the kernel
              reads: no value of a neighbour ever visits the host;
  ``n``       the global unpadded length: the kernels' own masking gives
              the zero-padded tail no term and zero gradient, so the
              sharded solve needs no objective wrapper.

Communication per call: one edge exchange (2 or 4 boundary values per rank)
and one all-reduce of the packed sums.  A problem without chain terms
(``quadratic``) skips the exchange and pays the all-reduce only
(``_needs_halo``).

Each wrapper also takes a batch, a shard's (B, d_local) lanes
(``sharded_vmap_minimize``, the reference's ``jax.vmap(...,
spmd_axis_name=...)`` over these wrappers): the edges become (B, count)
rows, every sum one per lane, and a call still makes one edge exchange
and one all-reduce for all lanes and launches the batched shard-local
kernel once.

On the CPU, where the tests run, the wrappers take the kernels' plain
shard-local versions (``dist.shardmap_vg``'s chunks), so the same
functions run there; ``use_pallas=False`` takes them on any device.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..kernels.fused_ops import BODY_IDS, local_fused_tail, local_fused_vg
from ..kernels.line_search_ops import local_multi_phi, local_multi_phi_dphi
from .mesh import Mesh
from .shardmap_vg import NEEDS_HALO

#: Problems with shard-composable kernels.
SHARDED_PALLAS_PROBLEMS = frozenset(BODY_IDS)


def _needs_halo(problem: str) -> bool:
    """Whether the problem's kernels read neighbour elements (chain terms).
    The others ignore their edges, so exchanging them would be dead latency
    on every iteration's critical path."""
    return NEEDS_HALO[problem]


def _edges(mesh: Mesh, problem: str, order: str, x, d=None):
    """The kernels' ``edges`` tensor on x's device, (count,) or for (B,
    d_local) rows (B, count).  ``order`` is "pn" (previous, next) for each
    vector in turn, or "n" (next only)."""
    count = (1 if d is None else 2) * len(order)
    if not _needs_halo(problem):
        return torch.zeros(x.shape[:-1] + (count,), dtype=x.dtype,
                           device=x.device)
    pairs = mesh.comm.edge_pair(*((x,) if d is None else (x, d)))
    prevs = [p for p, _ in pairs] if "p" in order else []
    return torch.stack(prevs + [nx for _, nx in pairs], dim=-1)


def shardmap_fused_vg(problem: str, mesh: Mesh, n: int,
                      use_pallas: bool = True) -> Callable:
    """vg(x_local) -> (f replicated, g local): the fused value-and-gradient
    kernel on this rank's block, one all-reduce for the value (one per lane
    for (B, d_local) rows).  ``n`` is the global unpadded length."""

    def vg(x_local):
        start = mesh.rank * x_local.shape[-1]
        edges = _edges(mesh, problem, "pn", x_local)
        f_part, g_local = local_fused_vg(problem, x_local, n, start, edges,
                                         use_pallas)
        (f,) = mesh.comm.reduce_parts([f_part], x_local.dtype)
        return f, g_local

    return vg


def shardmap_fused_tail(problem: str, mesh: Mesh, n: int,
                        with_matvec: bool = False,
                        accurate_dots: bool = False,
                        use_pallas: bool = True) -> Callable:
    """The fused post-line-search tail per shard, with the solver's
    contract ``tail(x, d, alpha, g, s_hist, y_hist)``: vectors stay local,
    the seven sums (and t1, t2 ``with_matvec``) are finished with ONE
    packed float64 all-reduce and rounded once.

    ``accurate_dots``: each shard compensates its own cross-block sum (the
    kernel's Neumaier stage 2); the group adds ``size`` float64 partials."""

    def tail(x, d, alpha, g, s_hist, y_hist):
        start = mesh.rank * x.shape[-1]
        edges = _edges(mesh, problem, "pn", x, d)
        x_new, g_new, s_row, y_row, sums = local_fused_tail(
            problem, x, d, alpha, g, s_hist, y_hist, with_matvec, n, start,
            edges, accurate_dots, use_pallas)
        (sums,) = mesh.comm.reduce_parts([sums], x.dtype)
        t1 = t2 = None
        if with_matvec:
            m = s_hist.shape[-2]
            sums, t1, t2 = sums.split((7, m, m), dim=-1)
        f_new, sy, yy, gg, dgn, ggn, ygn = sums.unbind(-1)
        return (x_new, f_new, g_new, s_row, y_row, sy, yy, gg, dgn, ggn,
                ygn, t1, t2)

    tail.accurate_dots = accurate_dots
    return tail


def shardmap_multi_phi(problem: str, mesh: Mesh, n: int,
                       use_pallas: bool = True) -> Callable:
    """phi_batch(x_local, d_local, alphas) -> (K,): all K trial values in
    one pass per shard, finished with one all-reduce of the (K,)
    partials; (B, K) for (B, d_local) rows and (B, K) alphas."""

    def phi_batch(x, d, alphas):
        start = mesh.rank * x.shape[-1]
        edges = _edges(mesh, problem, "n", x, d)
        parts = local_multi_phi(problem, x, d, alphas, n, start, edges,
                                use_pallas)
        (phis,) = mesh.comm.reduce_parts([parts], x.dtype)
        return phis

    return phi_batch


def shardmap_multi_phi_dphi(problem: str, mesh: Mesh, n: int,
                            use_pallas: bool = True) -> Callable:
    """phi_dphi_batch(x_local, d_local, alphas) -> ((K,), (K,)): all K trial
    (phi, phi') pairs in one pass per shard, finished with ONE all-reduce of
    the stacked (2, K) partials; (B, K) each for a batch."""

    def phi_dphi_batch(x, d, alphas):
        start = mesh.rank * x.shape[-1]
        edges = _edges(mesh, problem, "pn", x, d)
        phi_p, dphi_p = local_multi_phi_dphi(problem, x, d, alphas, n, start,
                                             edges, use_pallas)
        phis, dphis = mesh.comm.reduce_parts([phi_p, dphi_p], x.dtype)
        return phis, dphis

    return phi_dphi_batch
