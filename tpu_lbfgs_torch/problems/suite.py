"""Objective suite of the port: ``tpu_lbfgs.problems.suite`` (chained
Rosenbrock, the quadratic, the coupled quadratic and the sphere), with the
same formulas in the same order of operations.

Every function takes an optional leading batch axis: x is ``(..., d)``, f
is ``(...)``, and ``dir_poly`` returns its coefficients on the last axis,
``(..., 5)`` (``(..., 3)`` for the quadratic and the sphere).

``fused_value_and_grad``, ``fused_tail_for``, ``multi_phi_for`` and
``multi_phi_dphi_for`` hand out the CUDA kernels of ``kernels.fused_ops``
and ``kernels.line_search_ops`` for the problems that have a kernel body
(``quadratic``, ``rosenbrock``, ``coupled_quadratic``), or with
``use_pallas=False`` their plain PyTorch versions, as the reference hands
out its Pallas kernels or their jnp fallbacks.  The value and gradient and
the tail take one instance or a batch of (B, d) rows, as the reference's
do under ``jax.vmap``; the K-trial evaluators take one instance.
``sphere`` has no kernel body in the reference (its FUSED_VG, TAIL_BODIES
and F_BODIES lack it) and none here: under ``use_pallas=True`` it takes
the plain composition on any device, which is the reference's dispatch.

The kernels are float32 programs, and a wrapper raises for any other tensor
on the card.  A caller that knows the iterate's dtype asks
``resolve_use_pallas`` first, which applies the reference's ``pallas_ok``
rule in the open: for another dtype it warns and answers False, and the
caller builds the plain versions, on either device alike.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Optional

import numpy as np
import torch
from torch import Tensor

from ..kernels.fused_ops import (
    F_PLAIN,
    FUSED_VG,
    VG_PLAIN,
    _vdot,
    make_fused_tail,
    pallas_ok,
    rosenbrock_grad_plain,
)
from ..kernels.line_search_ops import make_multi_phi, make_multi_phi_dphi
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


def resolve_use_pallas(use_pallas: bool, dtype, who: str) -> bool:
    """``use_pallas`` as the four factories below should be given it for
    iterates of ``dtype``: unchanged for float32; for any other dtype
    (``--pallas --dtype float64``) False, with a warning, because the
    problem-specific kernels are float32 programs
    (``kernels.fused_ops.pallas_ok``, the reference's rule, under which it
    takes its jnp route).  The answer does not depend on the device."""
    if use_pallas and not pallas_ok(dtype):
        warnings.warn(
            f"{who}: use_pallas=True, but the problem-specific CUDA kernels "
            f"are float32 programs and the iterate is {dtype}; building "
            "their plain versions instead (use_pallas=False)", stacklevel=3)
        return False
    return bool(use_pallas)


def fused_value_and_grad(name: str, use_pallas: bool = True):
    """Objective and analytic gradient in one pass: the CUDA kernel of a
    problem with a kernel body (``kernels.fused_ops.FUSED_VG``; its plain
    version under ``use_pallas=False``), else the problem's plain
    ``value_and_grad``.  x is (d,) or a batch of (B, d) rows (f (B,)): pass
    it as ``value_and_grad=`` to minimize or to vmap_minimize."""
    if name not in FUSED_VG:
        return get_problem(name).value_and_grad
    return FUSED_VG[name] if use_pallas else VG_PLAIN[name]


def multi_phi_for(name: str, use_pallas: bool = True):
    """The K-trial evaluator ``phi_batch(x, d, alphas) -> (K,)``, f at
    every x + alphas[k] d in one pass; pass as ``phi_batch=`` to minimize /
    iterate for ``backtracking_speculative`` under ``ls_eval="direct"``.
    ``use_pallas=True`` gives the CUDA kernel of a problem with a kernel
    body, False or a problem without one the plain version."""
    f = F_PLAIN[name] if name in F_PLAIN else get_problem(name).f
    return make_multi_phi(name, f, use_pallas=use_pallas)


def multi_phi_dphi_for(name: str, use_pallas: bool = True):
    """The K-trial evaluator ``phi_dphi_batch(x, d, alphas) -> ((K,), (K,))``,
    f and grad f . d at every x + alphas[k] d in one pass; pass as
    ``phi_dphi_batch=`` for ``wolfe_interpolation_speculative`` and
    ``backtracking_wolfe_speculative`` under ``ls_eval="direct"``.
    ``use_pallas=True`` gives the CUDA kernel of a problem with a kernel
    body, False or a problem without one the plain version."""
    return make_multi_phi_dphi(name, fused_value_and_grad(name, False),
                               use_pallas=use_pallas)


#: The smallest d at which the fused tail's history products were measured.
_MATVEC_MEASURED_FROM = 1 << 16


def auto_with_matvec(m: int, d: int, history_dtype=None,
                     batch: int = 1) -> bool:
    """Whether ``fused_tail_for(with_matvec="auto")`` computes the history
    products t1 = S y, t2 = Y y inside the tail kernel, with the reference's
    signature.  The reference's rule is one of the TPU's VMEM and does not
    carry over; this one is from chip_smoke.py's ``[kernel]`` lines on an
    NVIDIA H100 80GB HBM3 (700 W), Rosenbrock body, where the tail with the
    products beat the tail without them plus the solver's two products at
    every size measured:

    - float32 ring, m = 10: 9.12 against 18.20 us at d = 2^16, 12.02
      against 28.91 at 2^18, 45.90 against 58.20 at 2^20 (m = 5: 32.76
      against 42.39; m = 20: 75.08 against 88.67), 606.85 against 671.52
      at 2^24;
    - bfloat16 ring, m = 10: 9.88 against 32.74 us at 2^16, 13.65 against
      49.23 at 2^18, 38.40 against 141.35 at 2^20, 480.03 against 1806.51
      at 2^24 (the solver's route widens the whole ring first).

    So True for one instance at any m >= 1 from d = 2^16 on, for a float32
    or bfloat16 ring (None is the iterate's dtype); below 2^16 nothing was
    measured, so it stays False there, as it does for a float64 ring (the
    kernel's rings are float32 and bfloat16) and for a batch: the batched
    kernel takes the products too, but the rule was measured for one
    instance only."""
    if history_dtype in ("float64", torch.float64):
        return False
    return bool(batch == 1 and m >= 1 and d >= _MATVEC_MEASURED_FROM)


def fused_tail_for(name: str, with_matvec="auto", use_pallas: bool = True,
                   m: int = 10, d: Optional[int] = None, history_dtype=None,
                   batch: int = 1, accurate_dots: bool = False):
    """The post-line-search tail ``tail(x, d, alpha, g, s_hist, y_hist)``
    for a suite problem, with the reference's signature; pass as
    ``fused_tail=`` to minimize / iterate.  ``use_pallas=True`` gives the
    CUDA kernel of a problem with a kernel body, False or a problem without
    one the plain composition.

    ``with_matvec``: True computes t1 = S y and t2 = Y y in the tail,
    False leaves them to the solver's two matrix-vector products, "auto"
    applies ``auto_with_matvec(m, d, history_dtype, batch)`` and needs
    ``d`` (without it: False).  The kernel's products take any history
    depth, as the reference's do.  ``accurate_dots`` builds the compensated tail, which
    ``cfg.accurate_dots`` requires (the solver rejects a plain one).  The
    tail takes one instance or a batched state, (B, d) rows with a
    (B, m, d) ring and one alpha per lane: pass it to ``solve_bounded`` /
    ``iterate`` over a state from ``init_state`` on a (B, d) x0."""
    if with_matvec == "auto":
        with_matvec = (auto_with_matvec(m, d, history_dtype, batch=batch)
                       if d is not None else False)
    return make_fused_tail(name, fused_value_and_grad(name, False),
                           with_matvec=with_matvec, use_pallas=use_pallas,
                           accurate_dots=accurate_dots)


def reference_x0(d: int, seed: int, low: float = -1000.0, high: float = 1000.0,
                 dtype=torch.float64, device=None) -> Tensor:
    """The starting point of the reference's experiment protocol, x0 ~
    U(low, high) (main.cpp:36-45; experiment seeds 42, 365, 12345, 777777,
    10000, main.cpp:33), on ``device`` (``types.resolve_device``: the
    current CUDA device unless "cpu" is asked for).

    Drawn in float64 by numpy's ``default_rng(seed).uniform`` and rounded
    to ``dtype``, as ``bench.harness._x0`` and the command line draw theirs;
    the reference draws with ``jax.random.uniform``, so the two packages'
    points for one seed differ.  Neither matches the C++ program's
    ``std::mt19937``, which is not needed: a parity run feeds one array to
    both solvers."""
    x = np.random.default_rng(seed).uniform(low, high, d)
    return torch.from_numpy(x).to(device=resolve_device(device), dtype=dtype)
