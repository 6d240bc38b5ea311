"""Every line search in a batched iterate, against the JAX package's
``jax.vmap(iterate)``, on the CPU.

B = 8 instances of chained Rosenbrock at d = 64, float64, from the
jittered -1.2 start of tests/test_torch_solver.py, under the configuration
of tests/test_torch_direct.py (REFERENCE_PARALLEL, ``compact_incremental``,
no alpha rescue), for 30 iterations.  Both packages start from the JAX
package's ``jax.vmap(init_state)``, carried over by interop.  Each port
iteration runs under both line-search loops (``iterate(bounded=...)``),
which must give the same state bit for bit, the fixed-trip one with no
host read.  Per lane and at every iteration: status, n_pairs, k, n_fev,
n_gev and the guard counters equal, and

- a search whose alpha comes from an exact ladder (the backtracking and
  backtracking-Wolfe families) runs free from x0: alpha equal, f and g_norm
  within 1e-9 or 100x the JAX package's own deviation from x0 moved by one
  ulp on every seventh coordinate (tests/test_torch_solver.py::
  test_f64_trajectory_matches_jax);
- an interpolating search restarts every iteration from the JAX package's
  state, with alpha within 1e-9 and f, g_norm within 1e-8 relative
  (tests/test_torch_direct.py::_follow_jax says why).

The JAX side is jitted.  Op by op (``jax.disable_jit``) it took 30-97 s a
case against 2 s jitted, and its alphas still differed from the port's in
the last bit on 1-21 of 240 lane-steps (jitted: 0-16, at most 4.1e-16
relative), so the restarts, not the eager run, are what hold the
interpolating searches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.core.solver import make_value_and_grad as jax_vg
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.linesearch import strategies as ls

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

STRATEGIES = list(tt.config.LINE_SEARCH_METHODS)
INTERPOLATING = ("armijo_interpolation", "wolfe_interpolation",
                 "wolfe_interpolation_speculative")
B, D, ITERS = 8, 64, 30
STEP_ALPHA_RTOL, STEP_RTOL = 1e-9, 1e-8


def _cfg(base, **kw):
    return base.REFERENCE_PARALLEL.replace(
        direction="compact_incremental", alpha_rescue_floor=None, **kw)


def _np_state(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _rel(a, b):
    return np.abs(a - b) / np.abs(a)


def _copy(state):
    """A state with its own buffers: iterate writes the ring in place."""
    return state.replace(**{f.name: getattr(state, f.name).clone()
                            for f in dataclasses.fields(state)})


def _assert_states_equal(a, b, what):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert torch.equal(x, y), (what, f.name)


def _follow_jax_batch(cfg_j, cfg_t, seed, poly=False):
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    vgj = jax_vg(pj.f, pj.grad)
    vgt = tt.make_value_and_grad(pt.f, pt.grad)
    dpj, dpt = (pj.dir_poly, pt.dir_poly) if poly else (None, None)
    init = jax.jit(jax.vmap(lambda x: tl.init_state(vgj, x, cfg_j.m)))
    step = jax.jit(jax.vmap(lambda s: tl.iterate(cfg_j, pj.f, vgj, s, dpj)))
    free = cfg_j.line_search not in INTERPOLATING
    x0 = -1.2 + np.random.default_rng(seed).uniform(-0.1, 0.1, (B, D))
    x1 = x0.copy()
    x1[:, ::7] = np.nextafter(x1[:, ::7], np.inf)
    sj, sp = init(jnp.asarray(x0)), init(jnp.asarray(x1))
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    for k in range(ITERS):
        if not free:
            st = interop.state_from_numpy(_np_state(sj), device="cpu")
        sj = step(sj)
        ls.reset_host_reads()
        fixed = tt.iterate(cfg_t, pt.f, vgt, _copy(st), dpt, bounded=True)
        assert ls.host_reads["line_search"] == 0, k
        st = tt.iterate(cfg_t, pt.f, vgt, st, dpt)
        _assert_states_equal(st, fixed, k)
        for name in ("status", "n_pairs", "k", "n_fev", "n_gev", "guards"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(sj, name)),
                                          err_msg=f"{name} at step {k}")
        if free:
            sp = step(sp)
            np.testing.assert_array_equal(st.alpha.numpy(),
                                          np.asarray(sj.alpha),
                                          err_msg=f"alpha at step {k}")
            for name in ("f", "g_norm"):
                ref = np.asarray(getattr(sj, name))
                bound = np.maximum(
                    1e-9, 100 * _rel(ref, np.asarray(getattr(sp, name))))
                dev = _rel(ref, getattr(st, name).numpy())
                assert (dev <= bound).all(), (k, name, dev.max(), bound)
        else:
            assert (_rel(np.asarray(sj.alpha), st.alpha.numpy())
                    <= STEP_ALPHA_RTOL).all(), k
            for name in ("f", "g_norm"):
                assert (_rel(np.asarray(getattr(sj, name)),
                             getattr(st, name).numpy()) <= STEP_RTOL).all(), \
                    (k, name)
    return st


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batched_direct_steps_match_jax(strategy, fidelity):
    """Direct evaluation: every trial is f (or f and g . d) of all 8 lanes
    in one pass, the speculative twins' K trials per lane K passes, as the
    reference's vmap evaluates them."""
    kw = dict(line_search=strategy, fidelity=fidelity, ls_eval="direct")
    st = _follow_jax_batch(_cfg(tl, **kw), _cfg(tt, **kw), seed=0)
    assert st.x.shape == (B, D)
    assert (st.status == tt.Status.RUNNING).all()


@pytest.mark.parametrize("strategy", [s for s in STRATEGIES
                                      if s != "backtracking"])
def test_batched_polynomial_steps_match_jax(strategy):
    """The directional polynomial: every search but backtracking (whose
    ladder tests/test_torch_batch.py holds) on one row of coefficients per
    lane, (B,) steps and (B, K) trial ladders."""
    kw = dict(line_search=strategy, ls_eval="polynomial")
    _follow_jax_batch(_cfg(tl, **kw), _cfg(tt, **kw), seed=1, poly=True)
