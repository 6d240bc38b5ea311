"""tpu_lbfgs_torch: the PyTorch and CUDA port of ``tpu_lbfgs``.

It mirrors the JAX package's module names and public functions, and runs
them as eager PyTorch on one device, with hand-written CUDA kernels (built
at first use, ``kernels/_build.py``) where the JAX package has Pallas
kernels.  The port so far covers the solve that ``bench.py`` times: chained
Rosenbrock, Armijo backtracking on the directional polynomial and the
incremental compact direction.  Options outside it raise
``NotImplementedError`` naming the ROADMAP item that brings them.

This package imports torch and never jax.
"""

from .config import LBFGSConfig
from .core.solver import (
    init_state,
    iterate,
    make_value_and_grad,
    minimize,
    solve_bounded,
    solve_from_state,
)
from .problems.suite import (
    Problem,
    fused_tail_for,
    fused_value_and_grad,
    get_problem,
)
from .types import Guard, LBFGSState, LineSearchResult, SolveResult, Status

__all__ = [
    "LBFGSConfig",
    "LBFGSState",
    "LineSearchResult",
    "SolveResult",
    "Status",
    "Guard",
    "Problem",
    "fused_tail_for",
    "fused_value_and_grad",
    "get_problem",
    "init_state",
    "iterate",
    "minimize",
    "make_value_and_grad",
    "solve_bounded",
    "solve_from_state",
]
