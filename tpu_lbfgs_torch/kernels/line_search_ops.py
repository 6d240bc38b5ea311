"""Hand-written CUDA kernels of the speculative line searches, each beside
its plain PyTorch version: K trial points of a line search in one pass over
(x, d).

  make_multi_phi       phi(alpha_k) = f(x + alpha_k d), k < K
                       (csrc/multi_phi.cu; replaces the Pallas
                       _make_multi_phi_kernel with each body of F_BODIES).
  make_multi_phi_dphi  (phi(alpha_k), grad f(x + alpha_k d) . d)
                       (csrc/multi_phi_dphi.cu; replaces the Pallas
                       _make_multi_phi_dphi_kernel with each body of
                       TAIL_BODIES).

Both kernels are templates on the problem's body (csrc/bodies.cuh):
``quadratic``, ``rosenbrock`` and ``coupled_quadratic``.

A kernel and its plain version form each sum from the same float32 terms,
accumulate in float64 and round once to the working dtype, so the two
differ only by the order of float64 additions (``fused_ops``' convention).
``alphas`` is a (K,) tensor on x's device, never read to the host.

A wrapper takes its plain version only for tensors on the CPU, where the
tests run.  A float32 CUDA tensor launches the kernel, and anything else on
the card raises (``fused_ops.pallas_ok`` is the dtype rule for callers that
choose ``use_pallas``).  ``launches`` counts each wrapper's kernel launches.

``local_multi_phi`` and ``local_multi_phi_dphi`` are the shard-local forms
for the sharded solve: one shard's block of x and d with the global
unpadded length ``n``, the shard's offset ``start`` and the neighbours'
boundary elements ``edges`` on the device; they return float64 partials,
unrounded, for the caller's packed all-reduce.  Their plain versions are
``multi_phi_local_plain`` and ``multi_phi_dphi_local_plain``.  They take
a batch too (``sharded_vmap_minimize``): (B, d_local) rows of x and d,
each lane's own K trials as (B, K) alphas and its own edges as (B, count)
rows, and give (B, K) partials; on the card one launch of the batched
shard-local kernel serves every lane.
"""
from __future__ import annotations

import torch
from torch import Tensor

from . import _build, counts
from .fused_ops import (
    BODY_IDS,
    F_PLAIN,
    VG_PLAIN,
    _check_edges,
    _check_vec,
    _dot,
    _lanes,
    _rows_dot64,
)

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {**{f"{name}_multi_phi": 0 for name in BODY_IDS},
            **{f"{name}_multi_phi_dphi": 0 for name in BODY_IDS},
            **{f"{name}_multi_phi_local": 0 for name in BODY_IDS},
            **{f"{name}_multi_phi_dphi_local": 0 for name in BODY_IDS},
            **{f"{name}_multi_phi_local_batched": 0 for name in BODY_IDS},
            **{f"{name}_multi_phi_dphi_local_batched": 0
               for name in BODY_IDS}}

#: The most trials one launch takes: 8 per row of blocks, 65535 rows.
MAX_TRIALS = 8 * 65535


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _trial_points(x: Tensor, d: Tensor, alphas: Tensor) -> Tensor:
    """(..., K, n): row k of each lane is x + alphas[..., k] d, rounded as
    a single trial is."""
    return x.unsqueeze(-2) + alphas.unsqueeze(-1) * d.unsqueeze(-2)


def multi_phi_plain(f, x: Tensor, d: Tensor, alphas: Tensor) -> Tensor:
    """f at the K trial points x + alphas[k] d, (K,): plain tensor ops and
    any f that reduces over the last axis (the reference's vmap
    fallback)."""
    return f(_trial_points(x, d, alphas))


def multi_phi_dphi_plain(vg, x: Tensor, d: Tensor,
                         alphas: Tensor) -> tuple[Tensor, Tensor]:
    """(f, grad f . d) at the K trial points, each (K,): plain tensor ops and
    any value-and-gradient function over the last axis; g . d accumulates
    in float64."""
    f, g = vg(_trial_points(x, d, alphas))
    return f, _dot(g, d)


def _check_alphas(x: Tensor, alphas: Tensor) -> int:
    """K, the trials per lane: alphas must be (K,) for a (n,) x, (B, K)
    for (B, n) rows, float32 and contiguous on x's device."""
    k = alphas.shape[-1] if alphas.dim() else 0
    if (alphas.device != x.device or alphas.dtype != torch.float32
            or alphas.shape[:-1] != x.shape[:-1] or alphas.dim() != x.dim()
            or not alphas.is_contiguous()):
        lead = tuple(x.shape[:-1])
        raise ValueError(f"alphas: expected a contiguous {lead + ('K',)} "
                         f"float32 tensor on {x.device}, got {alphas.dtype} "
                         f"{tuple(alphas.shape)} on {alphas.device}")
    if not 1 <= k <= MAX_TRIALS:
        raise ValueError(f"alphas: the kernels take 1 to {MAX_TRIALS} trials, "
                         f"got {k}")
    return k


def _launch(kernel: str, problem: str, x: Tensor, d: Tensor, alphas: Tensor,
            outputs: int, shard=None) -> Tensor:
    """Launch ``kernel`` (C symbol tl_<kernel>_f32) with the problem's body,
    counted as <problem>_<kernel>; returns its ``outputs * K`` sums.
    ``shard`` = (n, start, edges) launches the shard-local form
    (tl_<kernel>_local_f32, counted as <problem>_<kernel>_local), whose
    sums are float64, unrounded; with (B, n) rows and (B, K) alphas its
    batched form (tl_<kernel>_local_batched_f32, counted as
    <problem>_<kernel>_local_batched), whose sums come back as (outputs,
    K, B)."""
    lanes = _lanes(x)
    if lanes is not None and shard is None:
        raise ValueError(f"{kernel}: the whole-vector kernel takes one "
                         "instance; a batch takes the shard-local form")
    n = x.shape[-1]
    _check_vec("x", x, x.shape)
    _check_vec("d", d, x.shape, like=x)
    k = _check_alphas(x, alphas)
    lib = _build.load()
    partials = torch.empty(outputs * k * (lib.tl_max_blocks() + (lanes or 0)),
                           dtype=torch.float64, device=x.device)
    out = torch.empty(outputs * k * (lanes or 1), device=x.device,
                      dtype=torch.float32 if shard is None else torch.float64)
    args = (BODY_IDS[problem], x.data_ptr(), d.data_ptr(), alphas.data_ptr(),
            k, partials.data_ptr(), out.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if shard is None:
            name = f"{problem}_{kernel}"
            err = getattr(lib, f"tl_{kernel}_f32")(*args, n, stream)
        else:
            n_global, start, edges = shard
            _check_edges(edges, 2 * outputs, x, lanes)
            where = (n_global, start, edges.data_ptr())
            if lanes is None:
                name = f"{problem}_{kernel}_local"
                err = getattr(lib, f"tl_{kernel}_local_f32")(
                    *args, n, *where, stream)
            else:
                name = f"{problem}_{kernel}_local_batched"
                err = getattr(lib, f"tl_{kernel}_local_batched_f32")(
                    *args, lanes, n, *where, stream)
    _build.check(lib, err, name)
    counts.count(launches, name)
    return out if lanes is None else out.view(outputs, k, lanes)


def multi_phi_local_plain(problem: str, x: Tensor, d: Tensor, alphas: Tensor,
                          n: int, start: int, edges: Tensor) -> Tensor:
    """The (K,) float64 partials of f at the K trial points over one
    shard's owned terms, from plain tensor ops.  ``edges`` = [next shard's
    first x, next shard's first d].  A batch: (B, n) rows, (B, K) alphas,
    (B, 2) edges, (B, K) partials."""
    from ..dist.shardmap_vg import F_CHUNKS

    nxt = edges[..., 0, None] + alphas * edges[..., 1, None]
    return F_CHUNKS[problem](_trial_points(x, d, alphas), nxt, n, start)


def multi_phi_dphi_local_plain(problem: str, x: Tensor, d: Tensor,
                               alphas: Tensor, n: int, start: int,
                               edges: Tensor) -> tuple[Tensor, Tensor]:
    """The (K,) float64 partials of f and of grad f . d at the K trial
    points over one shard's block, from plain tensor ops.  ``edges`` =
    [previous shard's last x and d, next shard's first x and d].  A batch:
    (B, n) rows, (B, K) alphas, (B, 4) edges, (B, K) partials.  g . d is
    each product in float64 summed over the last axis
    (``fused_ops._rows_dot64``)."""
    from ..dist.shardmap_vg import CHUNKS

    prev = edges[..., 0, None] + alphas * edges[..., 1, None]
    nxt = edges[..., 2, None] + alphas * edges[..., 3, None]
    f_part, g = CHUNKS[problem](_trial_points(x, d, alphas), prev, nxt, n,
                                start)
    return f_part, _rows_dot64(g, d)


def local_multi_phi(problem: str, x: Tensor, d: Tensor, alphas: Tensor,
                    n: int, start: int, edges: Tensor,
                    use_pallas: bool = True) -> Tensor:
    """The shard-local K-trial values (the reference's
    ``_multi_phi_pallas`` with ``n``, ``start``, ``edges``): the CUDA
    kernel for float32 CUDA blocks (anything else on the card raises),
    ``multi_phi_local_plain`` for CPU tensors or under
    ``use_pallas=False``.  A batch gives (B, K) from one launch."""
    if use_pallas and x.device.type != "cpu":
        out = _launch("multi_phi", problem, x, d, alphas, 1,
                      shard=(n, start, edges))
        return out if x.dim() == 1 else out[0].t()
    return multi_phi_local_plain(problem, x, d, alphas, n, start, edges)


def local_multi_phi_dphi(problem: str, x: Tensor, d: Tensor, alphas: Tensor,
                         n: int, start: int, edges: Tensor,
                         use_pallas: bool = True) -> tuple[Tensor, Tensor]:
    """The shard-local K-trial (phi, phi') partials (the reference's
    ``_multi_phi_dphi_pallas`` with ``n``, ``start``, ``edges``), with
    ``local_multi_phi``'s dispatch."""
    if use_pallas and x.device.type != "cpu":
        out = _launch("multi_phi_dphi", problem, x, d, alphas, 2,
                      shard=(n, start, edges))
        if x.dim() > 1:
            return out[0].t(), out[1].t()
        phi, dphi = out.view(2, -1).unbind(0)
        return phi, dphi
    return multi_phi_dphi_local_plain(problem, x, d, alphas, n, start, edges)


def make_multi_phi(problem: str, f_fallback, use_pallas: bool = True):
    """``phi_batch(x, d, alphas) -> (K,)``, f at every x + alphas[k] d in
    one pass, with the reference's signature.  For a problem with a kernel
    body under ``use_pallas=True`` a CUDA tensor launches the kernel or
    raises, and a CPU tensor takes the plain version of the kernel's terms;
    otherwise it is the plain version around ``f_fallback`` on any device
    (the reference's vmap fallback)."""
    has_kernel = use_pallas and problem in BODY_IDS
    f_plain = F_PLAIN[problem] if has_kernel else f_fallback

    def phi_batch(x, d, alphas):
        if has_kernel and x.device.type != "cpu":
            return _launch("multi_phi", problem, x, d, alphas, 1)
        return multi_phi_plain(f_plain, x, d, alphas)

    return phi_batch


def make_multi_phi_dphi(problem: str, vg_fallback, use_pallas: bool = True):
    """``phi_dphi_batch(x, d, alphas) -> ((K,), (K,))``, f and grad f . d at
    every x + alphas[k] d in one pass, with the reference's signature and
    ``make_multi_phi``'s dispatch."""
    has_kernel = use_pallas and problem in BODY_IDS
    vg_plain = VG_PLAIN[problem] if has_kernel else vg_fallback

    def phi_dphi_batch(x, d, alphas):
        if has_kernel and x.device.type != "cpu":
            out = _launch("multi_phi_dphi", problem, x, d, alphas, 2)
            phi, dphi = out.view(2, -1).unbind(0)
            return phi, dphi
        return multi_phi_dphi_plain(vg_plain, x, d, alphas)

    return phi_dphi_batch


#: The direct-evaluation protocol's evaluators: chained Rosenbrock.
multi_phi_rosenbrock = make_multi_phi("rosenbrock", None)
multi_phi_dphi_rosenbrock = make_multi_phi_dphi("rosenbrock", None)
