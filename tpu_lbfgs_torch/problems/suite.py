"""Objective suite of the port: ``tpu_lbfgs.problems.suite`` for chained
Rosenbrock, the quadratic and the sphere, with the same formulas in the same
order of operations.  The coupled quadratic is still to be ported.

``fused_value_and_grad`` and ``fused_tail_for`` hand out the CUDA kernels of
``kernels.fused_ops`` (Rosenbrock only so far), or with
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
    fused_tail_plain,
    fused_tail_rosenbrock,
    fused_vg_rosenbrock,
    rosenbrock_vg_plain,
)


@dataclasses.dataclass(frozen=True)
class Problem:
    name: str
    f: Callable[[Tensor], Tensor]
    grad: Callable[[Tensor], Tensor]
    minimum_value: Optional[float] = None
    # Coefficients c (ascending) with f(x + a d) = sum_k c[k] a^k, for
    # cfg.ls_eval="polynomial".
    dir_poly: Optional[Callable[[Tensor, Tensor], Tensor]] = None

    def value_and_grad(self, x: Tensor) -> tuple[Tensor, Tensor]:
        return self.f(x), self.grad(x)


# --- quadratic: sum (x_i - 1)^2 ----------------------------------------------

def quadratic_f(x: Tensor) -> Tensor:
    r = x - 1.0
    return torch.sum(r * r)


def quadratic_grad(x: Tensor) -> Tensor:
    return 2.0 * (x - 1.0)


def quadratic_dir_poly(x: Tensor, d: Tensor) -> Tensor:
    r = x - 1.0
    return torch.stack([torch.dot(r, r), 2.0 * torch.dot(r, d),
                        torch.dot(d, d)])


# --- chained Rosenbrock ------------------------------------------------------

def rosenbrock_f(x: Tensor) -> Tensor:
    xi = x[:-1]
    xn = x[1:]
    t1 = xn - xi * xi
    t2 = 1.0 - xi
    return torch.sum(100.0 * t1 * t1 + t2 * t2)


def rosenbrock_grad(x: Tensor) -> Tensor:
    return rosenbrock_vg_plain(x)[1]


def rosenbrock_dir_poly(x: Tensor, d: Tensor) -> Tensor:
    # Per term i with A = x' - x^2, B = d' - 2 x d, C = -d^2, e = 1 - x
    # (primes at index i+1): 100 (A + B a + C a^2)^2 + (e - a d)^2.
    xi, xn = x[:-1], x[1:]
    di, dn = d[:-1], d[1:]
    A = xn - xi * xi
    B = dn - 2.0 * xi * di
    C = -di * di
    e = 1.0 - xi
    c0 = torch.sum(100.0 * A * A + e * e)
    c1 = torch.sum(200.0 * A * B - 2.0 * e * di)
    c2 = torch.sum(100.0 * (B * B + 2.0 * A * C) + di * di)
    c3 = torch.sum(200.0 * B * C)
    c4 = torch.sum(100.0 * C * C)
    return torch.stack([c0, c1, c2, c3, c4])


# --- sphere ------------------------------------------------------------------

def sphere_f(x: Tensor) -> Tensor:
    return torch.sum(x * x)


def sphere_grad(x: Tensor) -> Tensor:
    return 2.0 * x


def sphere_dir_poly(x: Tensor, d: Tensor) -> Tensor:
    return torch.stack([torch.dot(x, x), 2.0 * torch.dot(x, d),
                        torch.dot(d, d)])


_PROBLEMS = {
    "quadratic": Problem("quadratic", quadratic_f, quadratic_grad, 0.0,
                         quadratic_dir_poly),
    "rosenbrock": Problem("rosenbrock", rosenbrock_f, rosenbrock_grad, 0.0,
                          rosenbrock_dir_poly),
    "sphere": Problem("sphere", sphere_f, sphere_grad, 0.0, sphere_dir_poly),
}

# Problems whose value-and-gradient kernel is still a Pallas kernel only.
_UNPORTED_KERNELS = ("quadratic", "coupled_quadratic")


def get_problem(name: str) -> Problem:
    try:
        return _PROBLEMS[name]
    except KeyError:
        raise KeyError(f"unknown problem {name!r}; available: "
                       f"{sorted(_PROBLEMS)}") from None


def _unported_kernel(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"the {name} body of the fused kernels is not ported to "
        "tpu_lbfgs_torch yet (ROADMAP.md Queue 2 items 1-2); pass "
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
            "ported yet (ROADMAP.md Queue 2 item 1)")
    if accurate_dots:
        raise NotImplementedError(
            "the compensated fused tail (accurate_dots) is not ported yet "
            "(ROADMAP.md Queue 2 item 1)")
    if use_pallas and name == "rosenbrock":
        return fused_tail_rosenbrock
    if use_pallas and name in _UNPORTED_KERNELS:
        raise _unported_kernel(name)
    return partial(fused_tail_plain, fused_value_and_grad(name, False))
