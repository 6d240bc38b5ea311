"""Shard-local objective evaluation in plain tensor ops
(``tpu_lbfgs.dist.shardmap_vg``): per-shard chunks with one-element halos
and one all-reduce for the value.

Term i of a chain objective (rosenbrock, coupled_quadratic) belongs to the
shard that owns element i.  The shard's last term needs the next shard's
first element (forward halo) and the gradient of its first element needs
the previous shard's last (backward halo).  Whether a term exists is
decided on the global index ``start + i`` against the global unpadded
length ``n``, so a zero-padded tail contributes nothing and gets zero
gradient, and the halo values that wrap around at the two ends of the
vector are masked away.

Each chunk forms the terms of the whole-vector plain versions
(``kernels.fused_ops.VG_PLAIN`` / ``F_PLAIN``) in the same order, so the
concatenated gradients equal the whole-vector gradient bit for bit, and it
returns the value as the float64 sum of its terms, unrounded, for the
packed all-reduce (``comm.ShardComm``).  In the port these chunks are also
the plain versions of the shard-local CUDA kernels
(``kernels.fused_ops.local_fused_vg`` and the shard-local tail and K-trial
forms), which the CPU tests run.

The reference gets the sharded ``dir_poly`` from XLA's partitioner; here
``DIR_POLY_CHUNKS`` are its shard-local forms: the polynomial's
coefficients as float64 partials over the owned terms (forward halos of x
and d), finished by one packed all-reduce.

Every function takes optional leading batch axes (the lanes of a batch,
each lane's K trial points of a speculative line search); the halo values
then carry those axes too, one per lane (and trial), from the lane-aware
edge exchange (``comm.ShardComm.edge_pair``).  So the objectives over the
mesh below take one shard's (d_local,) block or a batch's (B, d_local)
rows and give a value per lane.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import Tensor

from .mesh import Mesh


def _sum64(t: Tensor) -> Tensor:
    return torch.sum(t, dim=-1, dtype=torch.float64)


def _gidx(x: Tensor, start: int) -> Tensor:
    return torch.arange(start, start + x.shape[-1], device=x.device)


def _next(x: Tensor, nxt: Tensor) -> Tensor:
    """x[i+1] for every local element; the last one's is ``nxt``."""
    return torch.cat([x[..., 1:], nxt.expand(x.shape[:-1])[..., None]], -1)


def _prev(x: Tensor, prev: Tensor) -> Tensor:
    """x[i-1] for every local element; the first one's is ``prev``."""
    return torch.cat([prev.expand(x.shape[:-1])[..., None], x[..., :-1]], -1)


# --- value and gradient -----------------------------------------------------

def _quadratic_f_chunk(x, nxt, n, start):
    r = x - 1.0
    return _sum64(torch.where(_gidx(x, start) < n, r * r, 0.0))


def _quadratic_chunk(x, prev, nxt, n, start):
    valid = _gidx(x, start) < n
    r = x - 1.0
    return (_sum64(torch.where(valid, r * r, 0.0)),
            torch.where(valid, 2.0 * r, 0.0))


def _rosenbrock_f_chunk(x, nxt, n, start):
    is_term = _gidx(x, start) < n - 1
    t = _next(x, nxt) - x * x
    e = 1.0 - x
    return _sum64(torch.where(is_term, 100.0 * t * t + e * e, 0.0))


def _rosenbrock_chunk(x, prev, nxt, n, start):
    gidx = _gidx(x, start)
    is_term = gidx < n - 1
    has_prev = (gidx >= 1) & (gidx < n)
    t = _next(x, nxt) - x * x
    e = 1.0 - x
    f_part = _sum64(torch.where(is_term, 100.0 * t * t + e * e, 0.0))
    g = torch.where(is_term, 2.0 * (x - 1.0) - 400.0 * x * t, 0.0)
    xp = _prev(x, prev)
    # Inbound 200 (x_i - x_{i-1}^2) from term i - 1.
    g = g + torch.where(has_prev, 200.0 * (x - xp * xp), 0.0)
    return f_part, g


def _coupled_terms(x, nxt, n, start):
    gidx = _gidx(x, start)
    valid, is_term = gidx < n, gidx < n - 1
    xf = _next(x, nxt)
    t = torch.where(valid, 1000.0 * x * x, 0.0)
    t = torch.where(is_term, t + 100.0 * (x * xf), t)
    return gidx, valid, is_term, xf, t


def _coupled_f_chunk(x, nxt, n, start):
    return _sum64(_coupled_terms(x, nxt, n, start)[-1])


def _coupled_chunk(x, prev, nxt, n, start):
    gidx, valid, is_term, xf, t = _coupled_terms(x, nxt, n, start)
    g = 2000.0 * x
    g = torch.where(is_term, g + 100.0 * xf, g)
    g = torch.where(gidx >= 1, g + 100.0 * _prev(x, prev), g)
    return _sum64(t), torch.where(valid, g, 0.0)


def _sphere_f_chunk(x, nxt, n, start):
    return _sum64(torch.where(_gidx(x, start) < n, x * x, 0.0))


def _sphere_chunk(x, prev, nxt, n, start):
    valid = _gidx(x, start) < n
    return (_sum64(torch.where(valid, x * x, 0.0)),
            torch.where(valid, 2.0 * x, 0.0))


#: ``chunk(x_local, prev_last, next_first, n, start) -> (float64 partial of
#: f, local gradient)`` per problem.
CHUNKS = {
    "quadratic": _quadratic_chunk,
    "rosenbrock": _rosenbrock_chunk,
    "coupled_quadratic": _coupled_chunk,
    "sphere": _sphere_chunk,
}

#: ``f_chunk(x_local, next_first, n, start) -> float64 partial of f``.
F_CHUNKS = {
    "quadratic": _quadratic_f_chunk,
    "rosenbrock": _rosenbrock_f_chunk,
    "coupled_quadratic": _coupled_f_chunk,
    "sphere": _sphere_f_chunk,
}

#: Problems whose chunks read a neighbour's element.
NEEDS_HALO = {"quadratic": False, "rosenbrock": True,
              "coupled_quadratic": True, "sphere": False}


# --- the directional polynomial ---------------------------------------------

def _quadratic_dir_poly_chunk(x, d, nx, nd, n, start):
    valid = _gidx(x, start) < n
    r = torch.where(valid, x - 1.0, 0.0)
    d = torch.where(valid, d, 0.0)
    return torch.stack([_sum64(r * r), 2.0 * _sum64(r * d), _sum64(d * d)],
                       dim=-1)


def _rosenbrock_dir_poly_chunk(x, d, nx, nd, n, start):
    # problems.suite.rosenbrock_dir_poly over the owned terms.
    is_term = _gidx(x, start) < n - 1
    xn, dn = _next(x, nx), _next(d, nd)
    A = xn - x * x
    B = dn - 2.0 * x * d
    C = -d * d
    e = 1.0 - x

    def s(t):
        return _sum64(torch.where(is_term, t, 0.0))

    return torch.stack([s(100.0 * A * A + e * e),
                        s(200.0 * A * B - 2.0 * e * d),
                        s(100.0 * (B * B + 2.0 * A * C) + d * d),
                        s(200.0 * B * C), s(100.0 * C * C)], dim=-1)


def _coupled_dir_poly_chunk(x, d, nx, nd, n, start, coeff=1000.0):
    gidx = _gidx(x, start)
    valid, is_term = gidx < n, gidx < n - 1
    k10 = coeff / 10.0
    xv, dv = torch.where(valid, x, 0.0), torch.where(valid, d, 0.0)
    xn, dn = _next(x, nx), _next(d, nd)

    def s(t):
        return _sum64(torch.where(is_term, t, 0.0))

    c0 = coeff * _sum64(xv * xv) + k10 * s(x * xn)
    c1 = 2.0 * coeff * _sum64(xv * dv) + k10 * (s(x * dn) + s(xn * d))
    c2 = coeff * _sum64(dv * dv) + k10 * s(d * dn)
    return torch.stack([c0, c1, c2], dim=-1)


def _sphere_dir_poly_chunk(x, d, nx, nd, n, start):
    valid = _gidx(x, start) < n
    x, d = torch.where(valid, x, 0.0), torch.where(valid, d, 0.0)
    return torch.stack([_sum64(x * x), 2.0 * _sum64(x * d), _sum64(d * d)],
                       dim=-1)


#: ``chunk(x_local, d_local, next_x, next_d, n, start) -> float64 partials
#: of the polynomial's coefficients``, ascending.
DIR_POLY_CHUNKS = {
    "quadratic": _quadratic_dir_poly_chunk,
    "rosenbrock": _rosenbrock_dir_poly_chunk,
    "coupled_quadratic": _coupled_dir_poly_chunk,
    "sphere": _sphere_dir_poly_chunk,
}


# --- the plain versions of the shard-local kernels --------------------------

def local_vg_plain(problem: str, x: Tensor, n: int, start: int,
                   edges: Tensor) -> tuple[Tensor, Tensor]:
    """(float64 partial of f, local gradient); ``edges`` = [previous
    shard's last x, next shard's first x], (2,), or for (B, d_local) rows
    one such pair per lane, (B, 2), with a partial per lane."""
    return CHUNKS[problem](x, edges[..., 0], edges[..., 1], n, start)


# --- objectives over the mesh ------------------------------------------------

def _zero(x: Tensor) -> Tensor:
    return x.new_zeros(())


def _halo(mesh: Mesh, problem: str, *vs: Tensor):
    """[(prev_last, next_first) for each v], exchanged only where the
    problem's chunks read them."""
    if NEEDS_HALO[problem]:
        return mesh.comm.edge_pair(*vs)
    return [(_zero(v), _zero(v)) for v in vs]


def shardmap_value_and_grad(problem: str, mesh: Mesh, n: int) -> Callable:
    """vg(x_local) -> (f replicated, g local): per-shard chunk, one halo
    exchange where the problem has chain terms, one all-reduce for the
    value.  ``n`` is the global unpadded length."""
    chunk = CHUNKS[problem]

    def vg(x):
        start = mesh.rank * x.shape[-1]
        ((prev, nxt),) = _halo(mesh, problem, x)
        f_part, g = chunk(x, prev, nxt, n, start)
        (f,) = mesh.comm.reduce_parts([f_part], x.dtype)
        return f, g

    return vg


def shardmap_value(problem: str, mesh: Mesh, n: int) -> Callable:
    """f(x_local) -> f replicated, as ``shardmap_value_and_grad``."""
    f_chunk = F_CHUNKS[problem]

    def f(x):
        start = mesh.rank * x.shape[-1]
        ((_, nxt),) = _halo(mesh, problem, x)
        (val,) = mesh.comm.reduce_parts([f_chunk(x, nxt, n, start)], x.dtype)
        return val

    return f


def shardmap_dir_poly(problem: str, mesh: Mesh, n: int) -> Callable:
    """dir_poly(x_local, d_local) -> the replicated coefficients of
    f(x + a d): one halo exchange (x and d together) where the problem has
    chain terms, one packed all-reduce.  It sees the unpadded vector by
    global-index ownership, so the crossing term at the pad boundary never
    enters."""
    chunk = DIR_POLY_CHUNKS[problem]

    def dir_poly(x, d):
        start = mesh.rank * x.shape[-1]
        (_, nx), (_, nd) = _halo(mesh, problem, x, d)
        (coeffs,) = mesh.comm.reduce_parts(
            [chunk(x, d, nx, nd, n, start)], x.dtype)
        return coeffs

    return dir_poly
