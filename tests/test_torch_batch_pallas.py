"""The batch solve on the kernels against the JAX package's, on the CPU.

The reference runs a batch on its kernels by ``jax.vmap``: its
``vmap_minimize`` under ``cfg.use_pallas`` (each iteration's tail through
the Pallas ``iteration_tail`` for float32), with a caller's
``value_and_grad=fused_value_and_grad(problem)``, and ``solve_bounded``
over a batched state with ``fused_tail=fused_tail_for(...)``.  The port
takes the same calls on (B, d) rows and launches the kernels' batched
forms on the card; on the CPU its wrappers run their plain versions, and
the JAX package's Pallas kernels run in interpret mode
(tests/conftest.py forces the cpu backend).  Inputs come from numpy.

- float64, bench.py's batch configuration with ``use_pallas=True`` (the
  reference takes its jnp tail for float64, the port its plain one), both
  lockstep modes: status, iterations, n_fev, n_gev and the guard counters
  equal per lane; f, g_norm and x within 1e-9 or 100x the JAX package's
  own deviation from x0 moved by one ulp (the bound of
  tests/test_torch_batch_search_solve.py), and under "while" the traced
  alpha of every lane at every step equal.
- float32 with the fused Rosenbrock value and gradient, 20 iterations
  against the vmapped interpreted kernels, per-lane f within the bound of
  tests/test_torch_batch.py's float32 lanes.
- ``solve_bounded`` over a batched state with the fused tail, with and
  without the history products: float64 as above, and float32 against
  the vmapped interpreted Pallas tail.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.batch import vmap_minimize as jax_vmap_minimize
from tpu_lbfgs_torch.kernels import chain, fused_ops

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

# bench.py's batch configuration (tpu_lbfgs/bench/harness.py::bench_batch).
BATCH = dict(line_search="backtracking", direction="compact_incremental",
             ls_eval="polynomial", fidelity="fixed",
             pair_skip_threshold=1e-10)


def _rel(a, b):
    return np.abs(a - b) / np.abs(a)


def _x0(B, d, seed, ulp=False):
    """Rosenbrock starts -1.2 + U(-0.1, 0.1); ``ulp`` moves every 7th entry
    by one float64 ulp."""
    x0 = -1.2 + np.random.default_rng(seed).uniform(-0.1, 0.1, (B, d))
    if ulp:
        x0[:, ::7] = np.nextafter(x0[:, ::7], np.inf)
    return x0


def _check_f64(got, ref, ref1, names=("f", "g_norm", "x")):
    """Counts equal per lane; f, g_norm and x within 1e-9 or 100x the JAX
    package's own deviation under a one-ulp move of x0 (``ref1``)."""
    for name in ("status", "iterations", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in names:
        want = np.asarray(getattr(ref, name))
        bound = np.maximum(1e-9, 100 * _rel(want, np.asarray(
            getattr(ref1, name))).max())
        assert (_rel(want, getattr(got, name).numpy()) <= bound).all(), name


@pytest.mark.parametrize("lockstep", ["while", "bounded"])
def test_vmap_minimize_use_pallas_matches_jax_f64(lockstep):
    """B = 8, d = 256 (a multiple of 128), 30 iterations, tol 1e-6 under
    "while" (lanes may stop) and 0 under "bounded"."""
    B, d = 8, 256
    tol = 1e-6 if lockstep == "while" else 0.0
    trace = lockstep == "while"
    cfg_j = tl.LBFGSConfig(**BATCH, use_pallas=True, max_iters=30, tol=tol,
                           record_trace=trace)
    cfg_t = tt.LBFGSConfig(**BATCH, use_pallas=True, max_iters=30, tol=tol,
                           record_trace=trace)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    ref, ref1 = (jax_vmap_minimize(pj.f, jnp.asarray(_x0(B, d, 3, u)), cfg_j,
                                   grad=pj.grad, dir_poly=pj.dir_poly,
                                   lockstep=lockstep) for u in (False, True))
    got = tt.vmap_minimize(pt.f, torch.from_numpy(_x0(B, d, 3)), cfg_t,
                           grad=pt.grad, dir_poly=pt.dir_poly,
                           lockstep=lockstep)
    _check_f64(got, ref, ref1)
    if trace:
        np.testing.assert_array_equal(got.trace.alpha.numpy(),
                                      np.asarray(ref.trace.alpha))


def test_vmap_minimize_fused_vg_f32_matches_jax():
    """float32, B = 64, d = 128, 20 bounded iterations of bench.py's batch
    configuration with ``use_pallas=True`` and the fused Rosenbrock value
    and gradient: the JAX package's runs its interpreted Pallas vg and
    ``iteration_tail`` under ``jax.vmap``.  Every lane runs the budget in
    both; per-lane f within rtol 5e-3 / atol 1e-4 on all but 2 lanes and
    within 2e-2 on every lane (tests/test_torch_batch.py::
    test_f32_batch_f_matches_jax: float32 sums in other orders drift a few
    knife-edge lanes; observed one lane at 7.2e-3, the median 2.4e-7);
    nothing is launched on the CPU."""
    B, d, iters = 64, 128, 20
    x0 = np.random.default_rng(42).uniform(-2.0, 2.0, (B, d)).astype(
        np.float32)
    cfg_j = tl.LBFGSConfig(**BATCH, use_pallas=True, max_iters=iters,
                           tol=0.0)
    cfg_t = tt.LBFGSConfig(**BATCH, use_pallas=True, max_iters=iters,
                           tol=0.0)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    ref = jax_vmap_minimize(pj.f, jnp.asarray(x0), cfg_j,
                            value_and_grad=tl.fused_value_and_grad(
                                "rosenbrock"),
                            dir_poly=pj.dir_poly, lockstep="bounded")
    fused_ops.reset_launches()
    chain.reset_launches()
    got = tt.vmap_minimize(pt.f, torch.from_numpy(x0), cfg_t,
                           value_and_grad=tt.fused_value_and_grad(
                               "rosenbrock"),
                           dir_poly=pt.dir_poly, lockstep="bounded")
    assert not any({**fused_ops.launches, **chain.launches}.values())
    assert got.f.dtype == torch.float32 and got.f.shape == (B,)
    assert (got.iterations.numpy() == iters).all()
    assert (np.asarray(ref.iterations) == iters).all()
    f, f_ref = got.f.numpy(), np.asarray(ref.f)
    within = np.abs(f - f_ref) <= 5e-3 * np.abs(f_ref) + 1e-4
    assert (~within).sum() <= 2, np.flatnonzero(~within)
    np.testing.assert_allclose(f, f_ref, rtol=2e-2)


def _solve_bounded_pair(problem, dtype, with_matvec, m, iters, B, d, seed,
                        damping=None):
    """``solve_bounded`` over a batched state with the fused tail in both
    packages: the JAX package's as ``jax.vmap`` of its per-instance solve,
    the port's over the (B, d) state; with the JAX package's run from x0
    moved by one ulp as well."""
    kw = dict(BATCH, m=m, max_iters=iters, tol=0.0, damping=damping)
    cfg_j, cfg_t = tl.LBFGSConfig(**kw), tt.LBFGSConfig(**kw)
    pj, pt = tl.get_problem(problem), tt.get_problem(problem)
    vg_j = tl.fused_value_and_grad(problem)
    tail_j = tl.fused_tail_for(problem, with_matvec=with_matvec, m=m)
    solve = jax.jit(jax.vmap(lambda x: tl.solve_bounded(
        cfg_j, pj.f, vg_j, tl.init_state(vg_j, x, m), pj.dir_poly,
        fused_tail=tail_j)))
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    x0 = _x0(B, d, seed).astype(np_dtype)
    ref, ref1 = (solve(jnp.asarray(_x0(B, d, seed, u).astype(np_dtype)))
                 for u in (False, True))
    vg_t = tt.fused_value_and_grad(problem)
    tail_t = tt.fused_tail_for(problem, with_matvec=with_matvec, m=m)
    got = tt.solve_bounded(cfg_t, pt.f, vg_t,
                           tt.init_state(vg_t, torch.from_numpy(x0), m),
                           pt.dir_poly, tail_t)
    return got, ref, ref1


@pytest.mark.parametrize("damping", [None, 0.2])
@pytest.mark.parametrize("with_matvec", [False, True])
@pytest.mark.parametrize("problem", ["rosenbrock", "coupled_quadratic"])
def test_solve_bounded_fused_tail_matches_vmapped_jax_f64(problem,
                                                          with_matvec,
                                                          damping):
    """float64, B = 8, d = 256, m = 5, 25 iterations: the fused tail with
    and without its history products over a batched state, and under
    Powell damping (the solver blends the tail's rows per lane and takes
    s.s = alpha^2 d.d per lane); per lane the state's alpha, status,
    n_pairs, k, n_fev, n_gev and guards equal, f, g_norm and x within the
    bound of ``_check_f64``."""
    got, ref, ref1 = _solve_bounded_pair(problem, torch.float64, with_matvec,
                                         5, 25, 8, 256, seed=4,
                                         damping=damping)
    for name in ("alpha", "status", "n_pairs", "k", "n_fev", "n_gev",
                 "guards"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("f", "g_norm", "x"):
        want = np.asarray(getattr(ref, name))
        bound = np.maximum(1e-9, 100 * _rel(want, np.asarray(
            getattr(ref1, name))).max())
        assert (_rel(want, getattr(got, name).numpy()) <= bound).all(), name


@pytest.mark.parametrize("with_matvec", [False, True])
def test_solve_bounded_fused_tail_matches_vmapped_pallas_f32(with_matvec):
    """float32, B = 8, d = 256, m = 5, 15 iterations of Rosenbrock: the
    JAX package's interpreted Pallas vg and tail (with the products in it
    or not) under ``jax.vmap`` against the port's plain versions over the
    batched state: every lane's k and status equal, f within rtol 5e-3 /
    atol 1e-4 (the float32 lanes' bound of tests/test_torch_batch.py;
    observed 2.0e-6, every lane's alpha equal)."""
    got, ref, _ = _solve_bounded_pair("rosenbrock", torch.float32,
                                      with_matvec, 5, 15, 8, 256, seed=5)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(ref.k))
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    assert got.f.dtype == torch.float32
    np.testing.assert_allclose(got.f.numpy(), np.asarray(ref.f), rtol=5e-3,
                               atol=1e-4)


# ROADMAP Queue 3, F11: the polynomial search compares trial values
# polyval(c, alpha), whose c0 is dir_poly's float32 sum of f's terms at x,
# with f(x) from the value and gradient.  The problem's f is that same
# float32 sum, so the two agree bit for bit; a kernel's f is summed apart
# (the reference's Pallas vg in float32 by blocks, pallas_ops.py:481; the
# port's in float64, csrc/fused_vg.cu), and where a lane's decrease is as
# small as the gap, its backtracking search fails.  Rows of bench.py's
# batch cell (bench_batch's x0) on which it shows within 40 iterations.
F11_ROWS = [280, 942, 1747, 3497]


def test_kernel_vg_apart_from_dir_poly_fails_lanes_in_both_packages():
    """Four lanes of the batch cell, 40 bounded iterations, float32: with
    the problem's f and gradient no lane fails in either package; with the
    fused value and gradient (the reference's interpreted Pallas kernel,
    the port's plain version of its kernel) lanes fail in both; and in the
    port with c0 taken from the value and gradient's own f, none does."""
    x0 = np.random.default_rng(42).uniform(
        -2.0, 2.0, (4096, 1024)).astype(np.float32)[F11_ROWS]
    kw = dict(BATCH, m=10, max_iters=40, tol=0.0)
    pt, pj = tt.get_problem("rosenbrock"), tl.get_problem("rosenbrock")

    def port(dir_poly=pt.dir_poly, **vg):
        r = tt.vmap_minimize(pt.f, torch.from_numpy(x0), tt.LBFGSConfig(**kw),
                             dir_poly=dir_poly, lockstep="bounded", **vg)
        return (r.status == tt.Status.LINE_SEARCH_FAILED).tolist()

    def ref(**vg):
        r = jax_vmap_minimize(pj.f, jnp.asarray(x0), tl.LBFGSConfig(**kw),
                              dir_poly=pj.dir_poly, lockstep="bounded", **vg)
        return (np.asarray(r.status) == tl.Status.LINE_SEARCH_FAILED).tolist()

    def dir_poly_vg_c0(x, d):
        c0 = fused_ops.VG_PLAIN["rosenbrock"](x)[0]
        return torch.cat([c0.unsqueeze(-1), pt.dir_poly(x, d)[..., 1:]], -1)

    assert not any(port(grad=pt.grad)) and not any(ref(grad=pj.grad))
    assert any(ref(value_and_grad=tl.fused_value_and_grad("rosenbrock")))
    vg = tt.fused_value_and_grad("rosenbrock")
    assert all(port(value_and_grad=vg))
    assert not any(port(dir_poly=dir_poly_vg_c0, value_and_grad=vg))
