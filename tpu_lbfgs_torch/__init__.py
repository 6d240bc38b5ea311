"""tpu_lbfgs_torch: the PyTorch and CUDA port of ``tpu_lbfgs``.

It mirrors the JAX package's module names and public functions, and runs
them as eager PyTorch on one device, with hand-written CUDA kernels (built
at first use, ``kernels/_build.py``) where the JAX package has Pallas
kernels.  The port so far covers the two solves that ``bench.py`` times
(chained Rosenbrock, Armijo backtracking on the directional polynomial and
the incremental compact direction, for one large instance with
``minimize`` and for a batch of small ones in lockstep with
``vmap_minimize``), and every line search with direct evaluation of its
trials for one instance, as the reference's own protocol runs them.
Options outside it raise ``NotImplementedError`` naming the ROADMAP item
that brings them.

This package imports torch and never jax.
"""

from .batch import vmap_minimize
from .config import REFERENCE_PARALLEL, REFERENCE_SEQUENTIAL, LBFGSConfig
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
    multi_phi_dphi_for,
    multi_phi_for,
)
from .types import Guard, LBFGSState, LineSearchResult, SolveResult, Status

__all__ = [
    "LBFGSConfig",
    "REFERENCE_PARALLEL",
    "REFERENCE_SEQUENTIAL",
    "LBFGSState",
    "LineSearchResult",
    "SolveResult",
    "Status",
    "Guard",
    "Problem",
    "fused_tail_for",
    "fused_value_and_grad",
    "get_problem",
    "multi_phi_dphi_for",
    "multi_phi_for",
    "init_state",
    "iterate",
    "minimize",
    "make_value_and_grad",
    "solve_bounded",
    "solve_from_state",
    "vmap_minimize",
]
