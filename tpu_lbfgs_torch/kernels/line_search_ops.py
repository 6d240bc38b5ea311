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
tests run.  A CUDA tensor launches the kernel (float32 only), and anything
else raises.  ``launches`` counts each wrapper's kernel launches.
"""
from __future__ import annotations

import torch
from torch import Tensor

from . import _build
from .fused_ops import BODY_IDS, F_PLAIN, VG_PLAIN, _check_vec, _dot

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {**{f"{name}_multi_phi": 0 for name in BODY_IDS},
            **{f"{name}_multi_phi_dphi": 0 for name in BODY_IDS}}

#: The most trials one launch takes: 8 per row of blocks, 65535 rows.
MAX_TRIALS = 8 * 65535


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _trial_points(x: Tensor, d: Tensor, alphas: Tensor) -> Tensor:
    """(K, n): row k is x + alphas[k] d, rounded as a single trial is."""
    return x + alphas[:, None] * d


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
    k = alphas.numel()
    if (alphas.device != x.device or alphas.dtype != torch.float32
            or alphas.dim() != 1 or not alphas.is_contiguous()):
        raise ValueError("alphas: expected a contiguous (K,) float32 vector "
                         f"on {x.device}, got {alphas.dtype} "
                         f"{tuple(alphas.shape)} on {alphas.device}")
    if not 1 <= k <= MAX_TRIALS:
        raise ValueError(f"alphas: the kernels take 1 to {MAX_TRIALS} trials, "
                         f"got {k}")
    return k


def _launch(kernel: str, problem: str, x: Tensor, d: Tensor, alphas: Tensor,
            outputs: int) -> Tensor:
    """Launch ``kernel`` (C symbol tl_<kernel>_f32) with the problem's body,
    counted as <problem>_<kernel>; returns its ``outputs * K`` sums."""
    n = x.numel()
    _check_vec("x", x, n)
    _check_vec("d", d, n, like=x)
    k = _check_alphas(x, alphas)
    lib = _build.load()
    partials = torch.empty(outputs * k * lib.tl_max_blocks(),
                           dtype=torch.float64, device=x.device)
    out = torch.empty(outputs * k, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"tl_{kernel}_f32")(
            BODY_IDS[problem], x.data_ptr(), d.data_ptr(), alphas.data_ptr(),
            k, partials.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    name = f"{problem}_{kernel}"
    _build.check(lib, err, name)
    launches[name] += 1
    return out


def make_multi_phi(problem: str, f_fallback, use_pallas: bool = True):
    """``phi_batch(x, d, alphas) -> (K,)``, f at every x + alphas[k] d in
    one pass, with the reference's signature.  For a problem with a kernel
    body under ``use_pallas=True`` a CUDA tensor launches the kernel or
    raises and a CPU tensor takes the plain version of the kernel's terms;
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
