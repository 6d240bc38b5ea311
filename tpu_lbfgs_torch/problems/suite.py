"""Objective suite of the port: ``tpu_lbfgs.problems.suite`` (chained
Rosenbrock, the quadratic, the coupled quadratic and the sphere), with the
same formulas in the same order of operations.

Every function takes an optional leading batch axis: x is ``(..., d)``, f
is ``(...)``, and ``dir_poly`` returns its coefficients on the last axis,
``(..., 5)`` (``(..., 3)`` for the quadratic and the sphere).

``fused_value_and_grad``, ``fused_tail_for``, ``multi_phi_for`` and
``multi_phi_dphi_for`` hand out the CUDA kernels of ``kernels.fused_ops``
and ``kernels.line_search_ops`` (Rosenbrock only so far), or with
``use_pallas=False`` the plain PyTorch composition, as the reference hands
out its Pallas kernels or their jnp fallbacks.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import torch
from torch import Tensor

from ..kernels.fused_ops import (
    _vdot,
    fused_tail_plain,
    fused_tail_rosenbrock,
    fused_vg_rosenbrock,
    rosenbrock_f_plain,
    rosenbrock_grad_plain,
    rosenbrock_vg_plain,
)
from ..kernels.line_search_ops import (
    multi_phi_dphi_plain,
    multi_phi_dphi_rosenbrock,
    multi_phi_plain,
    multi_phi_rosenbrock,
)
from ..types import resolve_device


@dataclasses.dataclass(frozen=True)
class Problem:
    name: str
    f: Callable[[Tensor], Tensor]
    grad: Callable[[Tensor], Tensor]
    minimum_value: Optional[float] = None
    # minimizer(d, dtype, device=None): the known minimizer as a (d,)
    # tensor, on the current CUDA device unless ``device`` says otherwise.
    minimizer: Optional[Callable[..., Tensor]] = None
    # Coefficients c (ascending) with f(x + a d) = sum_k c[k] a^k, for
    # cfg.ls_eval="polynomial".
    dir_poly: Optional[Callable[[Tensor, Tensor], Tensor]] = None

    def value_and_grad(self, x: Tensor) -> tuple[Tensor, Tensor]:
        return self.f(x), self.grad(x)


# --- quadratic: sum (x_i - 1)^2 ----------------------------------------------

def quadratic_f(x: Tensor) -> Tensor:
    r = x - 1.0
    return torch.sum(r * r, dim=-1)


def quadratic_grad(x: Tensor) -> Tensor:
    return 2.0 * (x - 1.0)


def quadratic_dir_poly(x: Tensor, d: Tensor) -> Tensor:
    r = x - 1.0
    return torch.stack([_vdot(r, r), 2.0 * _vdot(r, d), _vdot(d, d)], dim=-1)


# --- chained Rosenbrock ------------------------------------------------------

def rosenbrock_f(x: Tensor) -> Tensor:
    xi = x[..., :-1]
    xn = x[..., 1:]
    t1 = xn - xi * xi
    t2 = 1.0 - xi
    return torch.sum(100.0 * t1 * t1 + t2 * t2, dim=-1)


def rosenbrock_grad(x: Tensor) -> Tensor:
    return rosenbrock_grad_plain(x)


def rosenbrock_dir_poly(x: Tensor, d: Tensor) -> Tensor:
    # Per term i with A = x' - x^2, B = d' - 2 x d, C = -d^2, e = 1 - x
    # (primes at index i+1): 100 (A + B a + C a^2)^2 + (e - a d)^2.
    xi, xn = x[..., :-1], x[..., 1:]
    di, dn = d[..., :-1], d[..., 1:]
    A = xn - xi * xi
    B = dn - 2.0 * xi * di
    C = -di * di
    e = 1.0 - xi
    c0 = torch.sum(100.0 * A * A + e * e, dim=-1)
    c1 = torch.sum(200.0 * A * B - 2.0 * e * di, dim=-1)
    c2 = torch.sum(100.0 * (B * B + 2.0 * A * C) + di * di, dim=-1)
    c3 = torch.sum(200.0 * B * C, dim=-1)
    c4 = torch.sum(100.0 * C * C, dim=-1)
    return torch.stack([c0, c1, c2, c3, c4], dim=-1)


# --- coupled quadratic (tridiagonal), COEFFICIENT = 1000 ---------------------

COUPLED_COEFFICIENT = 1000.0


def coupled_quadratic_f(x: Tensor,
                        coeff: float = COUPLED_COEFFICIENT) -> Tensor:
    # coeff * sum x_i^2 + (coeff / 10) * sum x_i x_{i+1}
    return coeff * torch.sum(x * x, dim=-1) + (coeff / 10.0) * torch.sum(
        x[..., :-1] * x[..., 1:], dim=-1)


def coupled_quadratic_grad(x: Tensor,
                           coeff: float = COUPLED_COEFFICIENT) -> Tensor:
    g = 2.0 * coeff * x
    g[..., :-1] += (coeff / 10.0) * x[..., 1:]
    g[..., 1:] += (coeff / 10.0) * x[..., :-1]
    return g


def coupled_quadratic_dir_poly(x: Tensor, d: Tensor,
                               coeff: float = COUPLED_COEFFICIENT) -> Tensor:
    # K sum (x + a d)^2 + (K / 10) sum (x + a d)(x' + a d'):
    # c0 = f(x), c1 = 2K x.d + (K/10)(x.d' + x'.d), c2 = K d.d + (K/10) d.d'
    k10 = coeff / 10.0
    xi, xn, di, dn = x[..., :-1], x[..., 1:], d[..., :-1], d[..., 1:]
    c0 = coeff * _vdot(x, x) + k10 * torch.sum(xi * xn, dim=-1)
    c1 = (2.0 * coeff * _vdot(x, d)
          + k10 * (torch.sum(xi * dn, dim=-1) + torch.sum(xn * di, dim=-1)))
    c2 = coeff * _vdot(d, d) + k10 * torch.sum(di * dn, dim=-1)
    return torch.stack([c0, c1, c2], dim=-1)


# --- sphere ------------------------------------------------------------------

def sphere_f(x: Tensor) -> Tensor:
    return torch.sum(x * x, dim=-1)


def sphere_grad(x: Tensor) -> Tensor:
    return 2.0 * x


def sphere_dir_poly(x: Tensor, d: Tensor) -> Tensor:
    return torch.stack([_vdot(x, x), 2.0 * _vdot(x, d), _vdot(d, d)], dim=-1)


def _constant_minimizer(value: float):
    def minimizer(d: int, dtype, device=None) -> Tensor:
        return torch.full((d,), value, dtype=dtype,
                          device=resolve_device(device))
    return minimizer


_PROBLEMS = {
    "quadratic": Problem("quadratic", quadratic_f, quadratic_grad, 0.0,
                         _constant_minimizer(1.0), quadratic_dir_poly),
    "rosenbrock": Problem("rosenbrock", rosenbrock_f, rosenbrock_grad, 0.0,
                          _constant_minimizer(1.0), rosenbrock_dir_poly),
    "coupled_quadratic": Problem(
        "coupled_quadratic", coupled_quadratic_f, coupled_quadratic_grad,
        0.0, _constant_minimizer(0.0), coupled_quadratic_dir_poly),
    "sphere": Problem("sphere", sphere_f, sphere_grad, 0.0,
                      _constant_minimizer(0.0), sphere_dir_poly),
}

# Problems whose value-and-gradient kernel is still a Pallas kernel only.
_UNPORTED_KERNELS = ("quadratic", "coupled_quadratic")


def get_problem(name: str) -> Problem:
    try:
        return _PROBLEMS[name]
    except KeyError:
        raise KeyError(f"unknown problem {name!r}; available: "
                       f"{sorted(_PROBLEMS)}") from None


def problem_names() -> list[str]:
    return sorted(_PROBLEMS)


def register_problem(problem: Problem) -> None:
    _PROBLEMS[problem.name] = problem


def _unported_kernel(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {name} body of the fused kernels is not ported to "
        "tpu_lbfgs_torch yet (ROADMAP.md Queue 2 item 2); pass "
        "use_pallas=False for the plain PyTorch version")


def fused_value_and_grad(name: str, use_pallas: bool = True):
    """Objective and analytic gradient in one pass: the CUDA kernel
    (Rosenbrock), or the problem's plain ``value_and_grad`` when
    ``use_pallas`` is False or the reference has no kernel for it."""
    if name == "rosenbrock":
        return fused_vg_rosenbrock if use_pallas else rosenbrock_vg_plain
    if use_pallas and name in _UNPORTED_KERNELS:
        raise _unported_kernel(name)
    return get_problem(name).value_and_grad


def fused_tail_for(name: str, with_matvec: bool = False,
                   use_pallas: bool = True, accurate_dots: bool = False):
    """The post-line-search tail ``tail(x, d, alpha, g, s_hist, y_hist)``
    for a suite problem; pass as ``fused_tail=`` to minimize / iterate.
    ``use_pallas=True`` gives the CUDA kernel (Rosenbrock), False or a
    problem the reference has no kernel for the plain composition."""
    if with_matvec:
        raise NotImplementedError(
            "the fused tail's in-kernel history matvec (with_matvec) is not "
            "ported yet (ROADMAP.md Queue 2 item 2)")
    if accurate_dots:
        raise NotImplementedError(
            "the compensated fused tail (accurate_dots) is not ported yet "
            "(ROADMAP.md Queue 2 item 2)")
    if use_pallas and name == "rosenbrock":
        return fused_tail_rosenbrock
    if use_pallas and name in _UNPORTED_KERNELS:
        raise _unported_kernel(name)
    return partial(fused_tail_plain, fused_value_and_grad(name, False))


def multi_phi_for(name: str, use_pallas: bool = True):
    """The K-trial evaluator ``phi_batch(x, d, alphas) -> (K,)``, f at
    every x + alphas[k] d in one pass; pass as ``phi_batch=`` to minimize /
    iterate for ``backtracking_speculative`` under ``ls_eval="direct"``.
    ``use_pallas=True`` gives the CUDA kernel (Rosenbrock), False or a
    problem the reference has no kernel for the plain version."""
    if use_pallas and name == "rosenbrock":
        return multi_phi_rosenbrock
    if use_pallas and name in _UNPORTED_KERNELS:
        raise _unported_kernel(name)
    f = rosenbrock_f_plain if name == "rosenbrock" else get_problem(name).f
    return partial(multi_phi_plain, f)


def multi_phi_dphi_for(name: str, use_pallas: bool = True):
    """The K-trial evaluator ``phi_dphi_batch(x, d, alphas) -> ((K,), (K,))``,
    f and grad f . d at every x + alphas[k] d in one pass; pass as
    ``phi_dphi_batch=`` for ``wolfe_interpolation_speculative`` and
    ``backtracking_wolfe_speculative`` under ``ls_eval="direct"``.
    ``use_pallas=True`` gives the CUDA kernel (Rosenbrock), False or a
    problem the reference has no kernel for the plain version."""
    if use_pallas and name == "rosenbrock":
        return multi_phi_dphi_rosenbrock
    if use_pallas and name in _UNPORTED_KERNELS:
        raise _unported_kernel(name)
    return partial(multi_phi_dphi_plain, fused_value_and_grad(name, False))
