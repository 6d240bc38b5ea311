"""``vmap_minimize`` with every line search, against the JAX package's, on
the CPU, and ``solve_bounded`` in direct mode for one instance.

- The exact-ladder searches (the backtracking and backtracking-Wolfe
  families) run free for 30 float64 iterations at B = 8, d = 64 under
  both lockstep modes: status, iterations, n_fev, n_gev and the guard
  counters equal per lane; f, g_norm and x within 1e-9 or 100x the JAX
  package's own deviation from x0 moved by one ulp (the bound of
  tests/test_torch_batch.py::test_vmap_minimize_m7_matches_jax).
- A mixed batch under every search: lanes that fail (an infinite start),
  lanes that converge early, lanes that run to the budget.  Under "while"
  each lane equals the JAX package's vmapped while_loop and a finished
  lane keeps every field; "bounded" ends the failed lanes the same.
- ``solve_bounded`` on one instance with the kernels' plain versions takes
  the same iterates as ``solve_from_state`` bit for bit, and its searches
  read nothing on the host.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.batch import vmap_minimize as jax_vmap_minimize
from tpu_lbfgs_torch.linesearch import strategies as ls

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

STRATEGIES = list(tt.config.LINE_SEARCH_METHODS)
EXACT = ("backtracking", "backtracking_speculative", "backtracking_wolfe",
         "backtracking_wolfe_speculative", "backtracking_wolfe_bisect")


def _cfg(base, **kw):
    return base.REFERENCE_PARALLEL.replace(
        direction="compact_incremental", ls_eval="direct",
        alpha_rescue_floor=None, **kw)


def _rel(a, b):
    return np.abs(a - b) / np.abs(a)


@pytest.mark.parametrize("lockstep", ["while", "bounded"])
@pytest.mark.parametrize("strategy", EXACT)
def test_vmap_minimize_matches_jax(strategy, lockstep):
    cfg_j = _cfg(tl, line_search=strategy, max_iters=30, tol=0.0)
    cfg_t = _cfg(tt, line_search=strategy, max_iters=30, tol=0.0)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    x0 = -1.2 + np.random.default_rng(2).uniform(-0.1, 0.1, (8, 64))
    x1 = x0.copy()
    x1[:, ::7] = np.nextafter(x1[:, ::7], np.inf)
    ref, ref1 = (jax_vmap_minimize(pj.f, jnp.asarray(x), cfg_j, grad=pj.grad,
                                   lockstep=lockstep) for x in (x0, x1))
    ls.reset_host_reads()
    got = tt.vmap_minimize(pt.f, torch.from_numpy(x0), cfg_t, grad=pt.grad,
                           lockstep=lockstep)
    if lockstep == "bounded":
        assert ls.host_reads["line_search"] == 0
    for name in ("status", "iterations", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("f", "g_norm", "x"):
        want = np.asarray(getattr(ref, name))
        bound = np.maximum(1e-9, 100 * _rel(want, np.asarray(
            getattr(ref1, name))).max())
        assert (_rel(want, getattr(got, name).numpy()) <= bound).all(), name


def _mixed_x0():
    """Rosenbrock, B = 8, d = 32: lanes 0 and 5 start at infinity in one
    coordinate (their first search finds no finite trial and the lane
    fails), lanes 1 and 6 next to the minimum (they reach tol within a few
    iterations), the others from -1.2 + U(-0.1, 0.1) (they run on)."""
    rng = np.random.default_rng(21)
    x0 = -1.2 + rng.uniform(-0.1, 0.1, (8, 32))
    x0[[1, 6]] = 1.0 + rng.uniform(-1e-3, 1e-3, (2, 32))
    x0[0, 3] = x0[5, 17] = np.inf
    return x0


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mixed_batch_matches_jax(strategy):
    """Under "while": status, iterations, n_fev, n_gev and guards equal the
    JAX package's per lane, f within 1e-7 relative (float64 rounding
    amplified over 20 iterations, as in tests/test_torch_batch.py::
    test_while_freezes_a_converged_lane); the trace's rows after a lane's
    last iteration repeat that iteration's row (the lane is frozen); x of a
    failed lane is its start.  Under "bounded" the failed lanes end with
    the same fields bit for bit, and every lane's status, iterations and
    counts equal the JAX package's bounded run (an early lane polishes on
    past tol, and may then end in a failed search)."""
    cfg_j = _cfg(tl, line_search=strategy, max_iters=20, tol=1e-3)
    cfg_t = _cfg(tt, line_search=strategy, max_iters=20, tol=1e-3)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    x0 = _mixed_x0()
    ref, ref_b = (jax_vmap_minimize(pj.f, jnp.asarray(x0), cfg_j,
                                    grad=pj.grad, lockstep=lk)
                  for lk in ("while", "bounded"))
    run = {lk: tt.vmap_minimize(pt.f, torch.from_numpy(x0),
                                cfg_t.replace(record_trace=lk == "while"),
                                grad=pt.grad, lockstep=lk)
           for lk in ("while", "bounded")}
    r = run["while"]
    for name in ("status", "iterations", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    status, iters = r.status.numpy(), r.iterations.numpy()
    failed = status == tt.Status.LINE_SEARCH_FAILED
    early = status == tt.Status.CONVERGED
    assert failed.tolist() == [i in (0, 5) for i in range(8)]
    assert early[[1, 6]].all() and (iters[early] < 20).all()
    assert (iters[~failed & ~early] == 20).all()
    live = ~failed
    np.testing.assert_allclose(r.f.numpy()[live], np.asarray(ref.f)[live],
                               rtol=1e-7)
    np.testing.assert_array_equal(r.x.numpy()[failed], x0[failed])
    for lane in range(8):
        last = iters[lane] - 1
        for name in ("f", "g_norm", "alpha", "n_fev", "n_gev", "guards"):
            rows = getattr(r.trace, name)[lane, last:]
            torch.testing.assert_close(rows, rows[:1].expand_as(rows),
                                       rtol=0, atol=0, equal_nan=True,
                                       msg=f"lane {lane} {name}")
    b = run["bounded"]
    for name in ("status", "iterations", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(getattr(b, name).numpy(),
                                      np.asarray(getattr(ref_b, name)),
                                      err_msg=name)
    for name in ("x", "f", "status", "iterations", "n_fev", "n_gev",
                 "guards"):
        torch.testing.assert_close(getattr(b, name)[failed],
                                   getattr(r, name)[failed], rtol=0, atol=0,
                                   equal_nan=True, msg=name)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_single_instance_solve_bounded_reads_nothing(strategy):
    """One instance in direct mode with the kernels' plain versions (the
    fused vg and tail, the K-trial evaluators): ``solve_bounded`` equals
    ``solve_from_state`` over the same budget bit for bit, and no search
    reads its condition on the host."""
    p = tt.get_problem("rosenbrock")
    kw = dict(value_and_grad=tt.fused_value_and_grad("rosenbrock"),
              fused_tail=tt.fused_tail_for("rosenbrock"),
              phi_batch=tt.multi_phi_for("rosenbrock"),
              phi_dphi_batch=tt.multi_phi_dphi_for("rosenbrock"))
    cfg = _cfg(tt, line_search=strategy, max_iters=15, tol=0.0)
    x0 = torch.from_numpy(np.random.default_rng(4).uniform(-2, 2, 256))
    vg = kw["value_and_grad"]
    args = (kw["fused_tail"], kw["phi_batch"], kw["phi_dphi_batch"])
    ls.reset_host_reads()
    read = tt.solve_from_state(cfg, p.f, vg, tt.init_state(vg, x0, cfg.m),
                               None, *args)
    n_read = ls.host_reads["line_search"]
    ls.reset_host_reads()
    fixed = tt.solve_bounded(cfg, p.f, vg, tt.init_state(vg, x0, cfg.m),
                             None, *args)
    assert ls.host_reads["line_search"] == 0
    assert n_read >= 15          # the read-driven loop: one per turn
    for name in ("x", "f", "g", "g_norm", "k", "status", "alpha", "n_fev",
                 "n_gev", "guards", "n_pairs", "SY", "YY"):
        assert torch.equal(getattr(read, name), getattr(fixed, name)), name
    assert read.k.item() == 15
