"""Hand-written CUDA kernels of the speculative line searches, each beside
its plain PyTorch version: K trial points of a line search in one pass over
(x, d).

  multi_phi_rosenbrock       phi(alpha_k) = f(x + alpha_k d), k < K
                             (csrc/rosenbrock_multi_phi.cu; replaces the
                             Pallas _make_multi_phi_kernel with _f_rosenbrock).
  multi_phi_dphi_rosenbrock  (phi(alpha_k), grad f(x + alpha_k d) . d)
                             (csrc/rosenbrock_multi_phi_dphi.cu; replaces the
                             Pallas _make_multi_phi_dphi_kernel with
                             _body_rosenbrock).

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
from .fused_ops import (
    _check_vec,
    _dot,
    rosenbrock_f_plain,
    rosenbrock_vg_plain,
)

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {"rosenbrock_multi_phi": 0, "rosenbrock_multi_phi_dphi": 0}

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


def _launch(name: str, x: Tensor, d: Tensor, alphas: Tensor,
            outputs: int) -> Tensor:
    """Launch kernel ``name`` (C symbol tl_<name>_f32), counted; returns its
    ``outputs * K`` sums."""
    n = x.numel()
    _check_vec("x", x, n)
    _check_vec("d", d, n)
    k = _check_alphas(x, alphas)
    lib = _build.load()
    partials = torch.empty(outputs * k * lib.tl_max_blocks(),
                           dtype=torch.float64, device=x.device)
    out = torch.empty(outputs * k, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"tl_{name}_f32")(
            x.data_ptr(), d.data_ptr(), alphas.data_ptr(), k,
            partials.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, name)
    launches[name] += 1
    return out


def multi_phi_rosenbrock(x: Tensor, d: Tensor, alphas: Tensor) -> Tensor:
    """Chained Rosenbrock at K trial points, (K,): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return multi_phi_plain(rosenbrock_f_plain, x, d, alphas)
    return _launch("rosenbrock_multi_phi", x, d, alphas, 1)


def multi_phi_dphi_rosenbrock(x: Tensor, d: Tensor,
                              alphas: Tensor) -> tuple[Tensor, Tensor]:
    """Chained Rosenbrock's (phi, phi') at K trial points, each (K,): the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return multi_phi_dphi_plain(rosenbrock_vg_plain, x, d, alphas)
    out = _launch("rosenbrock_multi_phi_dphi", x, d, alphas, 2)
    phi, dphi = out.view(2, -1).unbind(0)
    return phi, dphi
