"""tpu_lbfgs_torch: the PyTorch and CUDA port of ``tpu_lbfgs``.

It mirrors the JAX package's module names and public functions, and runs
them as eager PyTorch, with hand-written CUDA kernels (built
at first use, ``kernels/_build.py``) where the JAX package has Pallas
kernels.  The port so far covers the two solves that ``bench.py`` times
(chained Rosenbrock, Armijo backtracking on the directional polynomial and
the incremental compact direction, for one large instance with
``minimize`` and for a batch of small ones in lockstep with
``vmap_minimize``), every line search with direct evaluation of its
trials, as the reference's own protocol runs them, or on the directional
polynomial, for one instance and for a batch (each search a lane-masked
turn: each search loop one CUDA graph WHILE node inside a captured block,
read-driven on the per-iteration loop, or a fixed trip that reads nothing
under ``solve_bounded`` and ``lockstep="bounded"``), the
solve of a caller's own objective (``minimize(f, x0)`` with the default
configuration and autograd's gradient, the three directions, damping,
compensated dots, traces, the periodic product refresh, segmented solves
and the SciPy-shaped front end), and the command line over the whole
problem suite (``python -m tpu_lbfgs_torch``, ``cli.py``): the fused
kernels of the quadratic and the coupled quadratic beside Rosenbrock's,
the fused tail's in-kernel history products and compensated sums, and a
history ring in bfloat16; and the sharded solve (``tpu_lbfgs_torch.dist``:
``sharded_minimize`` with one process per shard of the vector axis over
``torch.distributed``, ``--shard`` on the command line, and
``sharded_vmap_minimize``, a batch over the rows of a 2-D ``(b, d)`` mesh,
with the shard-local forms of the four fused kernel families for one
instance and for a batch); checkpoints (``io.save_state`` /
``load_state``, the reference's file); and the experiment harnesses
(``bench``: time to tolerance, the giant-instance cell, the reference
protocol, the sweep, strong scaling; ``utils.roofline``: the traffic model
on the H100; ``utils.profiling``: device traces).  A caller's own objective
runs on the sharded path too (``dist.partitioned``, DTensor), a sharded
solve resumes from its per-rank checkpoint on another mesh
(``io.save_state_sharded`` / ``load_state_sharded``,
``dist.solve_shard_from_state``), and ``--debug-nans`` checks a solve for
non-finite values.

The solve loops run blocks of iterations on the device (``core.blocks``):
on the card each block is a CUDA graph, captured once and replayed, its
line-search loops as WHILE nodes (``kernels.graph_if``), and the host
reads the loop's flags once per block, as the reference runs its loops,
its searches and its traced solve as one device program;
``eager_loops()`` runs the same blocks eagerly.

Where it runs: ``minimize`` and ``vmap_minimize`` solve on the device of
the tensor they are given, so a CPU tensor is the caller asking for the
CPU.  An entry point that is handed no tensor (``scipy_compat.minimize``
with a numpy or list ``x0``, ``problems.fixtures``, ``Problem.minimizer``,
``reference_x0``, ``io.load_state``) runs on the current CUDA device,
raises ``RuntimeError`` when there is none, and takes ``device="cpu"``.

This package imports torch and never jax.
"""

from .batch import vmap_minimize
from .config import REFERENCE_PARALLEL, REFERENCE_SEQUENTIAL, LBFGSConfig
from .core.blocks import eager_loops
from .core.solver import (
    finalize_result,
    init_state,
    iterate,
    make_solve_segment,
    make_value_and_grad,
    minimize,
    refresh_products,
    resolve_history_dtype,
    solve_bounded,
    solve_from_state,
)
from .problems.suite import (
    Problem,
    auto_with_matvec,
    fused_tail_for,
    fused_value_and_grad,
    get_problem,
    multi_phi_dphi_for,
    multi_phi_for,
    problem_names,
    reference_x0,
    register_problem,
)
from .types import (
    Guard,
    LBFGSState,
    LineSearchResult,
    SolveResult,
    Status,
    Trace,
)

__all__ = [
    "LBFGSConfig",
    "REFERENCE_PARALLEL",
    "REFERENCE_SEQUENTIAL",
    "LBFGSState",
    "LineSearchResult",
    "SolveResult",
    "Status",
    "Guard",
    "Trace",
    "Problem",
    "auto_with_matvec",
    "fused_tail_for",
    "fused_value_and_grad",
    "get_problem",
    "multi_phi_dphi_for",
    "multi_phi_for",
    "problem_names",
    "reference_x0",
    "register_problem",
    "init_state",
    "iterate",
    "minimize",
    "make_value_and_grad",
    "finalize_result",
    "make_solve_segment",
    "refresh_products",
    "resolve_history_dtype",
    "solve_bounded",
    "solve_from_state",
    "vmap_minimize",
    "eager_loops",
]
