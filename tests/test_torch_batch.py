"""The port's batch solve against the JAX package's, on the CPU.

A batch is one state with a leading lane axis (tpu_lbfgs_torch.core.solver);
the JAX package lifts its single-instance solver with ``jax.vmap``.  The
tests hold the port to it lane by lane: the batched iteration in float64,
bounded and while lockstep with failing and converging lanes, one float32
run of bench.py's batch configuration through the JAX package's
interpreted chain kernel, state interop and the entry point's errors.
Inputs come from numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.batch import vmap_minimize as jax_vmap_minimize
from tpu_lbfgs.core.solver import _polyval as jax_polyval
from tpu_lbfgs.core.solver import make_value_and_grad as jax_vg
from tpu_lbfgs.linesearch.strategies import backtracking as jax_backtracking
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.core.solver import _polyval, _running
from tpu_lbfgs_torch.kernels import chain, fused_ops
from tpu_lbfgs_torch.linesearch.strategies import backtracking

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

# bench.py's batch configuration (tpu_lbfgs/bench/harness.py::bench_batch).
BATCH = dict(line_search="backtracking", direction="compact_incremental",
             ls_eval="polynomial", fidelity="fixed",
             pair_skip_threshold=1e-10)


def _np_state(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _rel(a, b):
    return np.abs(a - b) / np.abs(a)


@pytest.mark.parametrize("fidelity,rescue", [("reference", None),
                                             ("fixed", None),
                                             ("reference", 1e-4),
                                             ("fixed", 1e-4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_backtracking_ladder_per_lane_matches_loop(fidelity, rescue, dtype):
    """The ladder over a batch of 40 lanes, each with its own polynomial,
    f(x) and g.d: every lane's alpha, trial count and rescue flag equal the
    reference's while_loop on that lane, bit for bit."""
    cfg_j = tl.LBFGSConfig(fidelity=fidelity, alpha_rescue_floor=rescue)
    cfg_t = tt.LBFGSConfig(fidelity=fidelity, alpha_rescue_floor=rescue)
    search_j = jax.jit(jax.vmap(lambda c, gd: jax_backtracking(
        cfg_j, lambda a: jax_polyval(c, a), None, c[0], gd)))
    rng = np.random.default_rng(5)
    lanes = 40
    coeffs = (rng.normal(size=(lanes, 5))
              * 10.0 ** rng.integers(-3, 4, size=(lanes, 5))).astype(dtype)
    ascent = np.arange(lanes) % 4 == 0
    coeffs[ascent, 1] = np.abs(coeffs[ascent, 1])   # nothing is accepted
    gd = np.where(ascent, np.abs(coeffs[:, 1]), -np.abs(coeffs[:, 1]))
    ref = search_j(jnp.asarray(coeffs), jnp.asarray(gd))
    ct = torch.from_numpy(coeffs)
    out = backtracking(cfg_t, lambda a: _polyval(ct[:, None, :], a), None,
                       ct[:, 0], torch.from_numpy(gd))
    assert out.alpha.shape == (lanes,) and out.alpha.dtype == ct.dtype
    np.testing.assert_array_equal(out.alpha.numpy(), np.asarray(ref.alpha))
    np.testing.assert_array_equal(out.n_fev.numpy(), np.asarray(ref.n_fev))
    np.testing.assert_array_equal(out.rescued.numpy(),
                                  np.asarray(ref.rescued))
    n_fev = np.asarray(ref.n_fev)
    assert (n_fev == 27).any() and (n_fev < 27).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_f64_trajectory_matches_jax(seed):
    """60 float64 iterations of the batched iterate at B = 8, d = 64, from
    the JAX package's ``jax.vmap(init_state)`` carried over by interop,
    with bench.py's batch configuration.  Per lane and at every step: equal
    alpha, status, n_pairs, k, n_fev and guards; f and g_norm within the
    bound of test_torch_solver.py::test_f64_trajectory_matches_jax, 1e-9 or
    100x the JAX package's own deviation from x0 moved by one ulp."""
    _check_batched_trajectory(seed, iters=60, m=10)


def _check_batched_trajectory(seed, iters, m):
    """The batched iterate at B = 8, d = 64, m pairs, float64, bench.py's
    batch configuration, from the JAX package's ``jax.vmap(init_state)``
    carried over by interop, against ``jax.vmap(iterate)`` step by step."""
    B, d = 8, 64
    cfg_j = tl.LBFGSConfig(**BATCH, m=m, max_iters=iters, tol=0.0)
    cfg_t = tt.LBFGSConfig(**BATCH, m=m, max_iters=iters, tol=0.0)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    vgj = jax_vg(pj.f, pj.grad)
    vgt = tt.make_value_and_grad(pt.f, pt.grad)
    init = jax.jit(jax.vmap(lambda x: tl.init_state(vgj, x, cfg_j.m)))
    step = jax.jit(jax.vmap(
        lambda s: tl.iterate(cfg_j, pj.f, vgj, s, pj.dir_poly)))
    x0 = -1.2 + np.random.default_rng(seed).uniform(-0.1, 0.1, (B, d))
    x1 = x0.copy()
    x1[:, ::7] = np.nextafter(x1[:, ::7], np.inf)
    sj, sp = init(jnp.asarray(x0)), init(jnp.asarray(x1))
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    assert st.s_hist.shape == (B, cfg_t.m, d)
    for k in range(iters):
        sj, sp = step(sj), step(sp)
        st = tt.iterate(cfg_t, pt.f, vgt, st, pt.dir_poly)
        for name in ("alpha", "status", "n_pairs", "k", "n_fev", "guards"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(sj, name)),
                                          err_msg=f"{name} at step {k}")
        for name in ("f", "g_norm"):
            ref = np.asarray(getattr(sj, name))
            bound = np.maximum(1e-9,
                               100 * _rel(ref, np.asarray(getattr(sp, name))))
            dev = _rel(ref, getattr(st, name).numpy())
            assert (dev <= bound).all(), (k, name, dev.max())
    assert (st.k.numpy() == iters).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_vmap_minimize_m7_matches_jax(seed):
    """m = 7, a depth the batched chain kernel takes since it takes any m,
    float64 at B = 8, d = 64, bench.py's batch configuration
    (compact_incremental): 40 iterations of the batched iterate step by
    step against the JAX package, then ``vmap_minimize`` in bounded
    lockstep against ``tpu_lbfgs.batch.vmap_minimize``: equal status,
    iterations, n_fev and guards per lane; f, g_norm and x within the bound
    of the step-by-step check, 1e-9 or 100x the JAX package's own deviation
    from x0 moved by one ulp."""
    _check_batched_trajectory(seed, iters=40, m=7)
    cfg_j = tl.LBFGSConfig(**BATCH, m=7, max_iters=40, tol=0.0)
    cfg_t = tt.LBFGSConfig(**BATCH, m=7, max_iters=40, tol=0.0)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    x0 = -1.2 + np.random.default_rng(seed).uniform(-0.1, 0.1, (8, 64))
    x1 = x0.copy()
    x1[:, ::7] = np.nextafter(x1[:, ::7], np.inf)
    ref, ref1 = (jax_vmap_minimize(pj.f, jnp.asarray(x), cfg_j, grad=pj.grad,
                                   dir_poly=pj.dir_poly, lockstep="bounded")
                 for x in (x0, x1))
    got = tt.vmap_minimize(pt.f, torch.from_numpy(x0), cfg_t, grad=pt.grad,
                           dir_poly=pt.dir_poly, lockstep="bounded")
    for name in ("status", "iterations", "n_fev", "guards"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("f", "g_norm", "x"):
        want = np.asarray(getattr(ref, name))
        bound = np.maximum(1e-9, 100 * _rel(want, np.asarray(
            getattr(ref1, name))).max())
        assert (_rel(want, getattr(got, name).numpy()) <= bound).all(), name


def _mixed_batch(backend):
    """tests/test_batch_bounded.py's mixed batch: the sphere, with
    params[b] = +1 for a normal lane and -1 for a lane whose gradient lies
    (its line search fails at once and the lane freezes).  Returns
    (f, grad, dir_poly, x0s, params) for "jax" (one lane) or "torch" (the
    batch)."""
    rng = np.random.default_rng(7)
    x0s = rng.uniform(0.5, 2.0, (8, 32))
    params = np.array([1.0, 1.0, -1.0, 1.0, 1.0, -1.0, 1.0, 1.0])
    if backend == "jax":
        poly = tl.get_problem("sphere").dir_poly
        return (lambda x, s: jnp.sum(x * x), lambda x, s: 2.0 * s * x,
                lambda x, d, s: poly(x, d), jnp.asarray(x0s),
                jnp.asarray(params))
    poly = tt.get_problem("sphere").dir_poly
    return (lambda x, s: torch.sum(x * x, dim=-1),
            lambda x, s: 2.0 * s[:, None] * x, lambda x, d, s: poly(x, d),
            torch.from_numpy(x0s), torch.from_numpy(params))


def test_bounded_matches_while_with_failed_lanes():
    """Bounded and while lockstep give the same result bit for bit on a
    fixed budget, failed lanes included (iterate is idempotent on them);
    status, iterations, n_fev and guards equal the JAX package's."""
    cfg_j = tl.LBFGSConfig(**BATCH, max_iters=25, tol=0.0, m=4)
    cfg_t = tt.LBFGSConfig(**BATCH, max_iters=25, tol=0.0, m=4)
    f, grad, poly, x0s, params = _mixed_batch("torch")
    runs = {lockstep: tt.vmap_minimize(
        f, x0s, cfg_t, grad=grad, problem_params=params, dir_poly=poly,
        lockstep=lockstep) for lockstep in ("while", "bounded")}
    for name in tt.SolveResult._fields:
        if name != "trace":
            assert torch.equal(getattr(runs["while"], name),
                               getattr(runs["bounded"], name)), name
    fj, gj, pj, x0j, pj_params = _mixed_batch("jax")
    ref = jax_vmap_minimize(fj, x0j, cfg_j, grad=gj, problem_params=pj_params,
                            dir_poly=pj, lockstep="bounded")
    r = runs["bounded"]
    for name in ("status", "iterations", "n_fev", "guards"):
        np.testing.assert_array_equal(getattr(r, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    st = r.status.numpy()
    assert (st == tt.Status.LINE_SEARCH_FAILED).sum() == 2
    failed = st == tt.Status.LINE_SEARCH_FAILED
    assert (r.iterations.numpy()[failed] == 1).all()
    assert (r.guards.numpy()[failed, tt.Guard.LANE_FREEZE] == 1).all()
    np.testing.assert_array_equal(r.x.numpy()[failed], x0s.numpy()[failed])


def _converging_batch():
    """Rosenbrock lanes from -1.2 + U(-0.1, 0.1), and lane 0 next to the
    minimum, which reaches tol long before the others."""
    x0 = -1.2 + np.random.default_rng(11).uniform(-0.1, 0.1, (4, 16))
    x0[0] = 1.0 + np.random.default_rng(12).uniform(-1e-3, 1e-3, 16)
    return x0


def test_while_freezes_a_converged_lane():
    """Under lockstep="while" a lane whose g_norm fell below tol stops: its
    x, f, ring rows and every counter stay bit for bit as they were while
    the other lanes run on.  The result equals vmap_minimize's and, per
    lane, the JAX package's vmapped while_loop: status and iterations
    equal, f within 1e-7 (float64 rounding, amplified ~1.4x per iteration
    on chained Rosenbrock over up to 40 iterations; observed 9e-9)."""
    cfg_t = tt.LBFGSConfig(**BATCH, max_iters=40, tol=1e-3)
    cfg_j = tl.LBFGSConfig(**BATCH, max_iters=40, tol=1e-3)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    x0 = _converging_batch()
    state = tt.init_state(vg, torch.from_numpy(x0), cfg_t.m)
    frozen = None
    while bool((running := _running(cfg_t, state)).any()):
        state = tt.iterate(cfg_t, p.f, vg, state, p.dir_poly, lanes=running)
        if frozen is None and not bool(_running(cfg_t, state)[0]):
            frozen = {k: v[0].clone() for k, v in vars(state).items()}
            k_frozen = int(state.k[0])
    assert frozen is not None and k_frozen < int(state.k.max()), \
        "lane 0 must stop while others run on"
    for name, v in frozen.items():
        assert torch.equal(getattr(state, name)[0], v), name
    r = tt.vmap_minimize(p.f, torch.from_numpy(x0), cfg_t, grad=p.grad,
                         dir_poly=p.dir_poly)
    assert torch.equal(r.x, state.x) and torch.equal(r.iterations, state.k)
    pj = tl.get_problem("rosenbrock")
    ref = jax_vmap_minimize(pj.f, jnp.asarray(x0), cfg_j, grad=pj.grad,
                            dir_poly=pj.dir_poly)
    np.testing.assert_array_equal(r.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(r.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_allclose(r.f.numpy(), np.asarray(ref.f), rtol=1e-7)
    assert r.status[0].item() == tt.Status.CONVERGED


def test_bounded_polishes_past_tol():
    """Under lockstep="bounded" the converged lane keeps iterating to the
    budget, f only improves, and it still reports CONVERGED."""
    cfg = tt.LBFGSConfig(**BATCH, max_iters=40, tol=1e-3)
    p = tt.get_problem("rosenbrock")
    x0 = torch.from_numpy(_converging_batch())
    rw = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly)
    rb = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly,
                          lockstep="bounded")
    assert rb.status[0].item() == tt.Status.CONVERGED
    assert rw.iterations[0].item() < rb.iterations[0].item() == 40
    assert rb.f[0].item() <= rw.f[0].item()
    assert (rb.iterations == 40).all()


@pytest.fixture(scope="module")
def f32_batch_runs():
    """bench.py's batch configuration at B = 1024, d = 128, 20 float32
    iterations, bounded lockstep, through both packages: the JAX package's
    chain runs as its Pallas kernel in interpret mode.  One run each, and
    one more of the port (half a second) from x0 with every 7th entry moved
    by one ulp, which measures how far each lane's trajectory amplifies
    rounding: ``sens`` is that run's relative deviation of f per lane."""
    B, d, iters = 1024, 128, 20
    x0 = np.random.default_rng(42).uniform(-2.0, 2.0, (B, d)).astype(
        np.float32)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    ref = jax_vmap_minimize(
        pj.f, jnp.asarray(x0), tl.LBFGSConfig(**BATCH, max_iters=iters,
                                              tol=0.0),
        grad=pj.grad, dir_poly=pj.dir_poly, lockstep="bounded")
    cfg = tt.LBFGSConfig(**BATCH, max_iters=iters, tol=0.0)

    def run(x):
        return tt.vmap_minimize(pt.f, torch.from_numpy(x), cfg, grad=pt.grad,
                                dir_poly=pt.dir_poly, lockstep="bounded")

    chain.reset_launches()
    fused_ops.reset_launches()
    got = run(x0)
    launched = {**chain.launches, **fused_ops.launches}
    x1 = x0.copy()
    x1[:, ::7] = np.nextafter(x1[:, ::7], np.float32(np.inf))
    sens = _rel(got.f.numpy(), run(x1).f.numpy())
    return ref, got, iters, launched, sens


def test_f32_batch_f_matches_jax(f32_batch_runs):
    """Per-lane f against the JAX package, within the reference's own
    kernel-vs-jnp float32 tolerance, rtol 5e-3 / atol 1e-4
    (tests/test_chain.py), on every lane but those whose trajectory
    amplifies rounding past it.  On these inputs both packages take the
    same alpha and the same pair decisions on every lane at every step;
    the two lanes outside (124 and 608, at 8.6e-3 and 1.3e-2) drift there
    from float32 sums in another order.  The JAX package moves the same
    two lanes by 6.4e-3 and 9.7e-3 when x0 moves by one ulp on every 7th
    entry.  So a lane that the port moves by more than 1e-3 under that
    perturbation (``sens``) is held within 10x of it instead: the packages
    differ by rounding at each of 20 steps, a deeper perturbation than one
    at x0 (observed ratio at most 3), and never beyond 2e-2."""
    ref, got, iters, launched, sens = f32_batch_runs
    assert got.f.dtype == torch.float32 and got.x.shape == (1024, 128)
    assert torch.isfinite(got.f).all()
    both = (got.status.numpy() == tt.Status.MAX_ITERS) \
        & (np.asarray(ref.status) == tt.Status.MAX_ITERS)
    assert both.sum() >= 1000
    f, f_ref, sens = got.f.numpy()[both], np.asarray(ref.f)[both], sens[both]
    err = np.abs(f - f_ref)
    within = err <= 5e-3 * np.abs(f_ref) + 1e-4
    sensitive = sens > 1e-3
    assert (~within).sum() <= 4, np.flatnonzero(~within)
    assert (within | sensitive).all(), np.flatnonzero(~within & ~sensitive)
    assert (err <= 10 * sens * np.abs(f_ref))[~within].all()
    np.testing.assert_allclose(f, f_ref, rtol=2e-2)
    assert all(v == 0 for v in launched.values()), launched


def test_f32_batch_status_counts_match_jax(f32_batch_runs):
    """Every lane runs the whole budget; the counts of each status, and the
    batch's total of each guard counter, agree within 4 of 1024 lanes
    (ROADMAP Queue 3: the polynomial search freezes a few knife-edge
    float32 lanes, and pairs near s.y = 0 are rejected or kept, depending
    on the order of the sums; observed equal)."""
    ref, got, iters, _, _ = f32_batch_runs
    assert (got.iterations.numpy() == iters).all()
    guard_diff = got.guards.numpy().sum(0) - np.asarray(ref.guards).sum(0)
    assert np.abs(guard_diff).max() <= 4, guard_diff
    counts = np.bincount(got.status.numpy(), minlength=4)
    ref_counts = np.bincount(np.asarray(ref.status), minlength=4)
    assert np.abs(counts - ref_counts).max() <= 4, (counts, ref_counts)


@pytest.mark.parametrize("d", [300, 1024])
def test_batched_interop_round_trip_is_exact(d):
    """A vmapped JAX state -> port -> JAX arrays is the identity: the
    (B, m, R, L) ring maps to (B, m, d) and back."""
    B = 3
    p = tl.get_problem("rosenbrock")
    cfg = tl.LBFGSConfig(**BATCH)
    vg = jax_vg(p.f, p.grad)
    x0 = jnp.asarray(np.random.default_rng(0).uniform(-2, 2, (B, d)))
    s = jax.vmap(lambda x: tl.init_state(vg, x, cfg.m))(x0)
    step = jax.jit(jax.vmap(lambda t: tl.iterate(cfg, p.f, vg, t,
                                                 p.dir_poly)))
    for _ in range(12):        # fill and wrap the ring
        s = step(s)
    arrays = _np_state(s)
    st = interop.state_from_numpy(arrays, device="cpu")
    assert st.s_hist.shape == (B, cfg.m, d) and st.s_hist.is_contiguous()
    assert st.guards.shape == (B, tt.Guard.N)
    back = interop.state_to_numpy(st)
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype and back[k].shape == a.shape, k
        np.testing.assert_array_equal(back[k], a, err_msg=k)


def test_vmap_minimize_errors():
    p = tt.get_problem("quadratic")
    x0 = torch.zeros((2, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="lockstep"):
        tt.vmap_minimize(p.f, x0, tt.LBFGSConfig(), grad=p.grad,
                         lockstep="nope")
    with pytest.raises(ValueError, match="record_trace"):
        tt.vmap_minimize(p.f, x0, tt.LBFGSConfig(record_trace=True),
                         grad=p.grad, lockstep="bounded")
    with pytest.raises(ValueError, match=r"\(B, d\)"):
        tt.vmap_minimize(p.f, x0[0], tt.LBFGSConfig(), grad=p.grad)
    # Without grad= autograd supplies each lane's gradient (it used to be a
    # ValueError): the solve equals the one with the analytic gradient.
    cfg = tt.LBFGSConfig(**BATCH, max_iters=3)
    auto = tt.vmap_minimize(p.f, x0, cfg, dir_poly=p.dir_poly)
    ref = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly)
    assert torch.equal(auto.x, ref.x)


def test_bench_batch_refuses_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py runs "
                    "bench_batch")
    from tpu_lbfgs_torch.bench.harness import bench_batch

    with pytest.raises(RuntimeError, match="CUDA"):
        bench_batch(batch=4, d=16, iters=2)
