"""Known-minimum quadratic fixtures (``tpu_lbfgs.problems.fixtures``):
seeded generators of SPD quadratic problems

    f(x) = 1/2 x'Ax - b'x        minimizer x* = A^{-1} b,  f* = -1/2 b'x*

with the ground truth from a direct solve in numpy, any dimension,
reproducible by seed.  The generator is the reference's, so one (dim, seed,
condition) names the same matrix in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.fused_ops import _vdot
from ..types import resolve_device
from .suite import Problem

FIXTURE_DIMS = (2, 3, 4, 5, 10, 50, 100, 500)


@dataclass(frozen=True)
class QuadraticFixture:
    """SPD quadratic with known ground truth."""
    dim: int
    seed: int
    A: np.ndarray          # (d, d) SPD
    b: np.ndarray          # (d,)
    minimizer: np.ndarray  # x* = A^{-1} b
    minimum_value: float   # f(x*)

    def problem(self, dtype=torch.float64, device=None) -> Problem:
        """The fixture as a Problem whose A and b live on the current CUDA
        device, or on ``device`` when given (the tests pass "cpu")."""
        device = resolve_device(device)
        A = torch.from_numpy(self.A).to(device=device, dtype=dtype)
        b = torch.from_numpy(self.b).to(device=device, dtype=dtype)
        x_star = self.minimizer

        def f(x):
            return 0.5 * _vdot(x, torch.mv(A, x)) - _vdot(b, x)

        def grad(x):
            return torch.mv(A, x) - b

        def minimizer(d, dt, device=None):
            return torch.from_numpy(x_star).to(
                device=resolve_device(device), dtype=dt)

        return Problem(
            name=f"spd_quadratic_d{self.dim}_s{self.seed}", f=f, grad=grad,
            minimum_value=self.minimum_value, minimizer=minimizer)


def make_spd_fixture(dim: int, seed: int = 0,
                     condition: float = 100.0) -> QuadraticFixture:
    """SPD matrix with a log-uniform spectrum in [1, condition] in a random
    orthogonal basis."""
    rng = np.random.default_rng(seed * 100003 + dim)
    Q, _ = np.linalg.qr(rng.normal(size=(dim, dim)))
    eigs = np.exp(rng.uniform(0.0, np.log(condition), dim))
    A = (Q * eigs) @ Q.T
    A = 0.5 * (A + A.T)  # exact symmetry
    b = rng.normal(size=dim)
    x_star = np.linalg.solve(A, b)
    f_star = float(0.5 * x_star @ (A @ x_star) - b @ x_star)
    return QuadraticFixture(dim=dim, seed=seed, A=A, b=b,
                            minimizer=x_star, minimum_value=f_star)


def fixture_suite(seed: int = 0, dims=FIXTURE_DIMS,
                  condition: float = 100.0):
    return [make_spd_fixture(d, seed, condition) for d in dims]
