"""Batched L-BFGS (``tpu_lbfgs.batch.vmapped``): B independent instances
solved in lockstep on one device.

The reference lifts its single-instance solver with ``jax.vmap``.  The port
writes the batch out instead: a (B, d) x0 gives a batched state whose every
field has a leading lane axis, and ``core.solver`` runs all lanes with the
same tensor ops, each lane taking its own decisions.  ``torch.func.vmap``
is not used: ``iterate`` updates the history ring in place.

Every line search runs on a batch, under ``ls_eval="direct"`` and
``"polynomial"``, in both fidelity modes: each search is one turn over the
lanes (``linesearch.strategies``), and a lane whose search has ended keeps
its carry, as under the reference's vmapped ``while_loop``.  In direct mode
a trial is one pass of f (or f and the gradient) over all B lanes, and K
trials per lane are K such passes; the K-trial kernels of
``problems.suite`` take one instance.

The kernels take the batch as the reference's take it under ``jax.vmap``,
one launch over all lanes: on the card a (B, d) state runs the batched
``iteration_tail`` kernel under ``cfg.use_pallas``, a caller's
``value_and_grad=fused_value_and_grad(problem)`` launches the batched
value-and-gradient kernel, and ``solve_bounded`` / ``iterate`` over a
batched state take ``fused_tail=fused_tail_for(problem, ...)``'s batched
tail (``kernels.fused_ops``).  The compact direction's small-matrix chain
runs its batched kernel whatever ``use_pallas`` says, as before.
"""
from __future__ import annotations

from typing import Callable, Optional

from torch import Tensor

from ..config import LBFGSConfig
from ..core.solver import init_state, make_value_and_grad, solve_to_result
from ..types import SolveResult


def vmap_minimize(f: Callable, x0_batch: Tensor,
                  cfg: LBFGSConfig = LBFGSConfig(),
                  grad=None, value_and_grad=None,
                  problem_params: Optional[Tensor] = None,
                  dir_poly=None, lockstep: str = "while") -> SolveResult:
    """Solve B independent instances in lockstep on x0_batch's device.

    Args:
      f, grad, value_and_grad, dir_poly: the objective's callables, written
         over a batch: x is (B, d), f returns (B,), dir_poly (B, n).  With
         ``problem_params`` each also takes the parameters as its last
         argument, ``f(x, params)``, with params batched on axis 0 (one row
         per lane).
      x0_batch: (B, d) starting points.
      lockstep: "while" (the default) stops each lane the moment its own
         loop condition (RUNNING, g_norm >= tol, k < max_iters) fails and
         keeps its state from then on, as the reference's vmapped
         ``while_loop`` does; it reads one scalar per iteration, whether
         any lane still runs, and each line search reads one flag per
         turn, whether any lane's search goes on.  "bounded" runs every
         lane for exactly cfg.max_iters iterations and each search for its
         own trip bound, and reads nothing on the host: failed lanes end
         the same, lanes that converge early keep polishing past tol (and
         report CONVERGED unless a later search fails).

    Returns a SolveResult whose fields carry the leading batch axis, a
    per-lane trace (B, max_iters, ...) under ``cfg.record_trace`` included.
    """
    if lockstep not in ("while", "bounded"):
        raise ValueError(f"lockstep must be 'while' or 'bounded', "
                         f"got {lockstep!r}")
    if lockstep == "bounded" and cfg.record_trace:
        # The reference's traced scan freezes lanes at convergence (while
        # semantics), so a traced bounded run would not be the bounded run.
        raise ValueError("lockstep='bounded' is incompatible with "
                         "cfg.record_trace (the traced scan freezes "
                         "finished lanes); trace with lockstep='while'")
    if x0_batch.dim() != 2:
        raise ValueError(f"x0_batch must be (B, d), got "
                         f"{tuple(x0_batch.shape)}")
    if problem_params is not None:
        params = problem_params

        def bind(fn):
            return None if fn is None else (lambda *a: fn(*a, params))

        f, grad, value_and_grad, dir_poly = map(
            bind, (f, grad, value_and_grad, dir_poly))
    vg = make_value_and_grad(f, grad, value_and_grad)
    state = init_state(vg, x0_batch, cfg.m, cfg.history_dtype)
    return solve_to_result(cfg, f, vg, state, dir_poly,
                           bounded=lockstep == "bounded")
