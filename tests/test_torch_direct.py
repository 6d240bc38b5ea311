"""The port's direct-evaluation solve against the JAX package, step for step,
on the CPU.

Every line search runs with ``ls_eval="direct"``, the way the reference's
protocol and convergence profiles run them: REFERENCE_PARALLEL with the
incremental compact direction, no alpha rescue, chained Rosenbrock at
d = 2048 in float64 from the jittered -1.2 start of
tests/test_torch_solver.py.  The speculative twins get their K-trial
evaluators (``multi_phi_for`` / ``multi_phi_dphi_for``; on CPU tensors the
plain versions), the JAX package its vmap fallback.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.kernels import fused_ops, line_search_ops

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

STRATEGIES = list(tt.config.LINE_SEARCH_METHODS)
# The searches whose alpha is an interpolated value.
INTERPOLATING = ("armijo_interpolation", "wolfe_interpolation",
                 "wolfe_interpolation_speculative")
D, ITERS = 2048, 60


def _direct(base, **kw):
    return base.REFERENCE_PARALLEL.replace(
        direction="compact_incremental", ls_eval="direct",
        alpha_rescue_floor=None, **kw)


def _np_state(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _rel(a, b):
    return abs(a - b) / abs(a)


def _torch_solver():
    p = tt.get_problem("rosenbrock")
    return dict(f=p.f, vg=tt.fused_value_and_grad("rosenbrock"),
                fused_tail=tt.fused_tail_for("rosenbrock"),
                phi_batch=tt.multi_phi_for("rosenbrock"),
                phi_dphi_batch=tt.multi_phi_dphi_for("rosenbrock"))


def _torch_step(cfg, state, s):
    return tt.iterate(cfg, s["f"], s["vg"], state, None, s["fused_tail"],
                      s["phi_batch"], s["phi_dphi_batch"])


# One interpolating step from the JAX package's state, float64: f and g . d
# differ in their last bits (sums in another order), and an interpolated
# alpha amplifies that through the cancellation in (phi(a) - phi(0) -
# phi'(0) a) / a^2.  Observed at most 3.5e-11 on alpha and 2.5e-9 on f and
# g_norm, under the textbook cubic of fidelity="fixed" (seeds 0 and 7).
STEP_ALPHA_RTOL, STEP_RTOL = 1e-9, 1e-8


def _follow_jax(cfg_j, step_j, step_t, x0, iters):
    """Steps both packages from x0 and holds the port to the JAX package at
    every iteration: status, n_pairs, guard counters, n_fev and n_gev
    equal, and

    - for a search whose alpha comes from an exact ladder (the backtracking
      and backtracking-Wolfe families), both run free from x0: alpha equal,
      f and g_norm within the bound of tests/test_torch_solver.py::
      test_f64_trajectory_matches_jax (1e-9, or 100x the JAX package's own
      deviation from x0 moved by one ulp on every seventh coordinate,
      whichever is larger);
    - an interpolating search's alpha is a continuous function of the
      iterate, so no two summation orders keep it equal along a free
      trajectory: the JAX package against itself, one ulp apart, changes
      its alphas within 19-79 iterations (seeds 0, 1, 2, 7).  So each of
      its iterations starts from the JAX package's state, with alpha, f and
      g_norm held to STEP_ALPHA_RTOL and STEP_RTOL."""
    free = cfg_j.line_search not in INTERPOLATING
    x1 = x0.copy()
    x1[::7] = np.nextafter(x1[::7], np.inf)
    sj = tl.init_state(step_j.vg, jnp.asarray(x0), cfg_j.m)
    sp = tl.init_state(step_j.vg, jnp.asarray(x1), cfg_j.m)
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    for k in range(iters):
        if not free:
            st = interop.state_from_numpy(_np_state(sj), device="cpu")
        sj, st = step_j(sj), step_t(st)
        assert st.status.item() == int(sj.status), k
        assert st.n_pairs.item() == int(sj.n_pairs), k
        assert st.guards.tolist() == np.asarray(sj.guards).tolist(), k
        assert st.n_fev.item() == int(sj.n_fev), k
        assert st.n_gev.item() == int(sj.n_gev), k
        if free:
            sp = step_j(sp)
            assert st.alpha.item() == float(sj.alpha), k
            for name in ("f", "g_norm"):
                ref = float(getattr(sj, name))
                bound = max(1e-9, 100 * _rel(ref, float(getattr(sp, name))))
                assert _rel(ref, getattr(st, name).item()) <= bound, (k,
                                                                      name)
        else:
            assert _rel(float(sj.alpha), st.alpha.item()) <= \
                STEP_ALPHA_RTOL, k
            for name in ("f", "g_norm"):
                assert _rel(float(getattr(sj, name)),
                            getattr(st, name).item()) <= STEP_RTOL, (k, name)
    return st


def _jax_stepper(cfg, dir_poly=None):
    p = tl.get_problem("rosenbrock")
    vg = tl.fused_value_and_grad("rosenbrock", use_pallas=True)
    tail = tl.fused_tail_for("rosenbrock", with_matvec=False, use_pallas=True)
    step = jax.jit(lambda s: tl.iterate(cfg, p.f, vg, s, dir_poly, tail))
    step.vg = vg
    return step


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_f64_direct_trajectory_matches_jax(strategy, fidelity):
    """60 float64 iterations against the JAX package (``_follow_jax``);
    then the port's minimize from x0 ends where the port's own steps from
    its init_state end."""
    cfg_j = _direct(tl, line_search=strategy, fidelity=fidelity)
    cfg_t = _direct(tt, line_search=strategy, fidelity=fidelity)
    solver = _torch_solver()
    x0 = -1.2 + np.random.default_rng(7).uniform(-0.1, 0.1, D)
    st = _follow_jax(cfg_j, _jax_stepper(cfg_j),
                     lambda s: _torch_step(cfg_t, s, solver), x0, ITERS)
    assert st.status.item() == tt.Status.RUNNING

    xt = torch.from_numpy(x0)
    st = tt.init_state(solver["vg"], xt, cfg_t.m)
    for _ in range(ITERS):
        st = _torch_step(cfg_t, st, solver)
    r = tt.minimize(solver["f"], xt, cfg_t.replace(max_iters=ITERS, tol=0.0),
                    value_and_grad=solver["vg"],
                    fused_tail=solver["fused_tail"],
                    phi_batch=solver["phi_batch"],
                    phi_dphi_batch=solver["phi_dphi_batch"])
    assert r.iterations.item() == ITERS
    assert r.status.item() == tt.Status.MAX_ITERS
    assert torch.equal(r.x, st.x)
    assert r.n_fev.item() == st.n_fev.item()
    assert r.n_gev.item() == st.n_gev.item()


@pytest.mark.parametrize("twin", ["backtracking_speculative",
                                  "wolfe_interpolation_speculative",
                                  "backtracking_wolfe_speculative"])
def test_twin_solve_walks_the_sequential_iterates(twin):
    """A speculative twin's solve, through its K-trial evaluator, takes its
    sequential search's steps: at float64, d = 256, the same iterates (only
    n_fev and n_gev differ: K per round)."""
    seq = twin.removesuffix("_speculative")
    solver = _torch_solver()
    x0 = torch.from_numpy(np.random.default_rng(8).uniform(-2, 2, 256))
    out = {}
    for name in (seq, twin):
        cfg = _direct(tt, line_search=name, max_iters=40, tol=1e-8)
        out[name] = tt.minimize(solver["f"], x0, cfg,
                                value_and_grad=solver["vg"],
                                fused_tail=solver["fused_tail"],
                                phi_batch=solver["phi_batch"],
                                phi_dphi_batch=solver["phi_dphi_batch"])
    a, b = out[seq], out[twin]
    assert a.iterations.item() == b.iterations.item()
    assert a.status.item() == b.status.item()
    torch.testing.assert_close(b.x, a.x, rtol=1e-12, atol=1e-12)
    assert b.n_fev.item() > a.n_fev.item()


@pytest.mark.parametrize("strategy", ["backtracking_wolfe_speculative",
                                      "wolfe_interpolation"])
def test_polynomial_mode_runs_every_search(strategy):
    """ls_eval="polynomial" with a search other than backtracking: the
    loops run on the Horner phi and follow the JAX package for 20 float64
    iterations (``_follow_jax``)."""
    kw = dict(line_search=strategy, ls_eval="polynomial",
              direction="compact_incremental", c2=0.9)
    cfg_j, cfg_t = tl.LBFGSConfig(**kw), tt.LBFGSConfig(**kw)
    pt = tt.get_problem("rosenbrock")
    vg, tail = tt.fused_value_and_grad("rosenbrock"), tt.fused_tail_for(
        "rosenbrock")
    _follow_jax(cfg_j, _jax_stepper(cfg_j, tl.get_problem("rosenbrock")
                                    .dir_poly),
                lambda s: tt.iterate(cfg_t, pt.f, vg, s, pt.dir_poly, tail),
                -1.2 + np.random.default_rng(9).uniform(-0.1, 0.1, 512), 20)


def test_cpu_direct_run_launches_no_kernel():
    """On the CPU the twins' evaluators take the plain versions."""
    line_search_ops.reset_launches()
    fused_ops.reset_launches()
    solver = _torch_solver()
    for twin in ("backtracking_speculative",
                 "wolfe_interpolation_speculative"):
        r = tt.minimize(solver["f"], torch.full((128,), -1.2),
                        _direct(tt, line_search=twin, max_iters=3, tol=0.0),
                        value_and_grad=solver["vg"],
                        fused_tail=solver["fused_tail"],
                        phi_batch=solver["phi_batch"],
                        phi_dphi_batch=solver["phi_dphi_batch"])
        assert r.iterations.item() == 3
    assert {"rosenbrock_multi_phi", "rosenbrock_multi_phi_dphi"} <= set(
        line_search_ops.launches)
    assert not any(line_search_ops.launches.values())
    assert not any(fused_ops.launches.values())


@pytest.mark.parametrize("call", [
    lambda: tt.multi_phi_for("quadratic"),
    lambda: tt.multi_phi_dphi_for("quadratic"),
    lambda: tt.multi_phi_for("coupled_quadratic"),
    lambda: tt.multi_phi_dphi_for("coupled_quadratic"),
])
def test_unported_kernel_bodies_raise(call):
    """The quadratic and coupled bodies of the K-trial kernels used to
    raise; they are ported now, and on the CPU each evaluator is the plain
    version of its kernel (tests/test_torch_suite_kernels.py holds those to
    the interpreted Pallas kernels)."""
    evaluator = call()
    x = torch.linspace(-1.0, 1.0, 50)
    d = torch.cos(3.0 * x)
    alphas = torch.tensor([0.5, 0.25, 0.125])
    out = evaluator(x, d, alphas)
    phi = out[0] if isinstance(out, tuple) else out
    assert phi.shape == (3,)
    name = "quadratic" if phi[0] < 1e3 else "coupled_quadratic"
    f = tt.get_problem(name).f
    for a, v in zip(alphas, phi):
        np.testing.assert_allclose(v.item(), f((x + a * d).double()).item(),
                                   rtol=1e-5)


def test_reference_configs_mirror_jax():
    assert tt.REFERENCE_PARALLEL.__dict__ == tl.REFERENCE_PARALLEL.__dict__
    assert tt.REFERENCE_SEQUENTIAL.__dict__ == \
        tl.REFERENCE_SEQUENTIAL.__dict__
