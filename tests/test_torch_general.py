"""The bring-your-own-objective solve against the JAX package, on the CPU:
the default configuration, the three directions, damping, accurate_dots,
refresh_interval, record_trace, segmented solves, autograd's gradient, the
coupled quadratic, the fixtures and the SciPy-shaped front end.

Everything runs in float64 at d = 64-256 from inputs made with numpy.
Both solvers start from one state (the JAX package's ``init_state``,
carried over with ``tpu_lbfgs_torch.interop``) where a test goes step by
step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs import scipy_compat as jax_scipy
from tpu_lbfgs.problems import fixtures as jax_fixtures
from tpu_lbfgs.utils import compensated_dot as jax_compensated_dot
from tpu_lbfgs_torch import interop, scipy_compat
from tpu_lbfgs_torch.core import solver as tsolver
from tpu_lbfgs_torch.problems import fixtures
from tpu_lbfgs_torch.utils import compensated_dot, compensated_norm_sq

torch.set_num_threads(1)

D = 128
# Step-by-step parity in float64.  The two packages sum in different
# orders, which moves f by ~1e-16 relative at the start; L-BFGS on chained
# Rosenbrock amplifies that about 1.4x per iteration
# (tests/test_torch_solver.py), so over ITERS = 40 iterations f and
# ||g|| are held to 1e-8 relative (observed below 1e-10); alpha (a power
# of the shrink factor), status, n_pairs, the counters and the guards are
# equal.
ITERS = 40
STEP_RTOL = 1e-8


def _np_state(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _x0(seed=0, d=D):
    return -1.2 + np.random.default_rng(seed).uniform(-0.1, 0.1, d)


def _problems():
    return tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")


# Each case: config keywords, and whether the Rosenbrock fused tail (with
# the directional polynomial) replaces the plain vg + iteration_tail chain.
CASES = {
    "two_loop": (dict(direction="two_loop"), False),
    "compact": (dict(direction="compact"), False),
    "compact_incremental": (dict(direction="compact_incremental"), False),
    "two_loop_skip": (dict(direction="two_loop", pair_skip_threshold=1e-10,
                           fidelity="fixed"), False),
    "use_pallas": (dict(direction="compact_incremental", use_pallas=True),
                   False),
    "damping_two_loop": (dict(direction="two_loop", damping=0.2), False),
    "damping_compact": (dict(direction="compact", damping=0.2), False),
    "damping_incremental": (dict(direction="compact_incremental",
                                 damping=0.2), False),
    "damping_fused_tail": (dict(direction="compact_incremental", damping=0.2,
                                ls_eval="polynomial"), True),
    "accurate_dots": (dict(direction="compact_incremental",
                           accurate_dots=True), False),
    "accurate_dots_use_pallas": (dict(direction="two_loop",
                                      accurate_dots=True, use_pallas=True),
                                 False),
    "accurate_dots_damping": (dict(direction="compact_incremental",
                                   accurate_dots=True, damping=0.2), False),
    "wolfe_compact": (dict(direction="compact", c2=0.9,
                           line_search="backtracking_wolfe"), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_f64_trajectory_matches_jax(case):
    """ITERS iterations of ``iterate`` in both packages from one state, per
    direction and option; under damping the Guard.DAMPED counts must move
    and agree."""
    kw, fused = CASES[case]
    cj, ct = tl.LBFGSConfig(**kw), tt.LBFGSConfig(**kw)
    pj, pt = _problems()
    vgj = tl.make_value_and_grad(pj.f, pj.grad)
    vgt = tt.make_value_and_grad(pt.f, pt.grad)
    tail_j = tl.fused_tail_for("rosenbrock", with_matvec=False,
                               use_pallas=False) if fused else None
    tail_t = tt.fused_tail_for("rosenbrock", use_pallas=False) \
        if fused else None
    step = jax.jit(lambda s: tl.iterate(cj, pj.f, vgj, s, pj.dir_poly,
                                        tail_j))
    sj = tl.init_state(vgj, jnp.asarray(_x0()), cj.m)
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    for k in range(ITERS):
        sj = step(sj)
        st = tt.iterate(ct, pt.f, vgt, st, pt.dir_poly, tail_t)
        for name in ("alpha", "status", "n_pairs", "k", "n_fev", "n_gev",
                     "guards"):
            np.testing.assert_array_equal(getattr(st, name).numpy(),
                                          np.asarray(getattr(sj, name)),
                                          err_msg=f"{name} at step {k}")
        for name in ("f", "g_norm"):
            np.testing.assert_allclose(getattr(st, name).item(),
                                       float(getattr(sj, name)),
                                       rtol=STEP_RTOL,
                                       err_msg=f"{name} at step {k}")
    if "damping" in case:
        assert st.guards[tt.Guard.DAMPED].item() > 0
    if kw["direction"] != "compact_incremental":
        # The products are carried unchanged, not computed.
        assert not st.SY.any() and not st.Yg.any()
    else:
        for name in ("SY", "YY", "Sg", "Yg"):
            ref = np.asarray(getattr(sj, name))
            np.testing.assert_allclose(getattr(st, name).numpy(), ref,
                                       rtol=0, atol=1e-7 * np.abs(ref).max(),
                                       err_msg=name)


def test_damped_products_use_the_raw_y():
    """The incremental Sg / Yg advance by S y_raw / Y y_raw, not by the
    damped row (where the reference once had a bug): after damped
    iterations the carried products still equal a fresh contraction of the
    ring with the gradient, to the drift of 40 float64 additions."""
    ct = tt.LBFGSConfig(direction="compact_incremental", damping=0.2)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    st = tt.init_state(vg, torch.from_numpy(_x0()), ct.m)
    for _ in range(ITERS):
        st = tt.iterate(ct, p.f, vg, st)
    assert st.guards[tt.Guard.DAMPED].item() > 5
    fresh = tt.refresh_products(st)
    for name in ("SY", "YY", "Sg", "Yg"):
        a, b = getattr(st, name), getattr(fresh, name)
        # SY's rows below the diagonal (s_new . y_older) are never read by
        # the compact algebra and are left stale by design: compare the
        # entries the chain reads, through the direction they give.
        if name in ("Sg", "Yg", "YY"):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-9 * b.abs().max().item(),
                                       err_msg=name)
    from tpu_lbfgs_torch.core.direction import compute_direction
    d_inc = compute_direction(ct, st)
    d_new = compute_direction(ct.replace(direction="compact"), st)
    np.testing.assert_allclose(d_inc.numpy(), d_new.numpy(), rtol=0,
                               atol=1e-8 * d_new.abs().max().item())


def _refresh_points(monkeypatch):
    """Record state.k at every refresh_products call of the port."""
    seen = []
    real = tsolver.refresh_products

    def spy(state, comm=None):
        seen.append(int(state.k))
        return real(state, comm)

    monkeypatch.setattr(tsolver, "refresh_products", spy)
    return seen


REFRESH = dict(direction="compact_incremental", refresh_interval=7, tol=0.0)


@pytest.mark.parametrize("solve,max_iters,points", [
    # solve_from_state: a refresh after every segment, the last included.
    ("solve_from_state", 30, [7, 14, 21, 28, 30]),
    # solve_bounded: after every full interval, none after the remainder.
    ("solve_bounded", 30, [7, 14, 21, 28]),
    ("solve_bounded", 28, [7, 14, 21, 28]),
    # interval >= max_iters: the bounded solve never refreshes.
    ("solve_bounded", 5, []),
])
def test_refresh_interval_matches_jax(monkeypatch, solve, max_iters, points):
    """The final state of a refreshed solve against the JAX package's
    (x, f, the four products), and the refresh points, which are the
    reference's: relative to the k the solve starts from."""
    kw = dict(REFRESH, max_iters=max_iters)
    cj, ct = tl.LBFGSConfig(**kw), tt.LBFGSConfig(**kw)
    pj, pt = _problems()
    vgj = tl.make_value_and_grad(pj.f, pj.grad)
    vgt = tt.make_value_and_grad(pt.f, pt.grad)
    sj0 = tl.init_state(vgj, jnp.asarray(_x0(1)), cj.m)
    st0 = interop.state_from_numpy(_np_state(sj0), device="cpu")
    sj = jax.jit(lambda s: getattr(tl, solve)(cj, pj.f, vgj, s))(sj0)
    seen = _refresh_points(monkeypatch)
    st = getattr(tt, solve)(ct, pt.f, vgt, st0)
    assert seen == points
    assert st.k.item() == int(sj.k) == max_iters
    assert st.status.item() == int(sj.status)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x), rtol=1e-8,
                               atol=1e-10)
    for name in ("SY", "YY", "Sg", "Yg"):
        ref = np.asarray(getattr(sj, name))
        np.testing.assert_allclose(getattr(st, name).numpy(), ref, rtol=0,
                                   atol=1e-7 * np.abs(ref).max(),
                                   err_msg=name)


def test_refresh_resumed_solve_counts_from_its_k(monkeypatch):
    """A state resumed at k = 5 refreshes at 12, 19, ... under
    solve_from_state (each segment counts from the k it starts at) and
    runs max_iters more iterations under solve_bounded."""
    ct = tt.LBFGSConfig(**REFRESH, max_iters=20)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)

    def resumed():
        st = tt.init_state(vg, torch.from_numpy(_x0(2)), ct.m)
        for _ in range(5):
            st = tt.iterate(ct, p.f, vg, st)
        return st

    seen = _refresh_points(monkeypatch)
    out = tt.solve_from_state(ct, p.f, vg, resumed())
    assert seen == [12, 19, 20] and out.k.item() == 20
    del seen[:]
    out = tt.solve_bounded(ct, p.f, vg, resumed())
    assert seen == [12, 19] and out.k.item() == 25


def test_refresh_products_matches_jax():
    cj = tl.LBFGSConfig(direction="compact_incremental")
    pj, _ = _problems()
    vgj = tl.make_value_and_grad(pj.f, pj.grad)
    sj = tl.init_state(vgj, jnp.asarray(_x0(3)), cj.m)
    step = jax.jit(lambda s: tl.iterate(cj, pj.f, vgj, s))
    for _ in range(15):
        sj = step(sj)
    st = tt.refresh_products(interop.state_from_numpy(_np_state(sj),
                                                      device="cpu"))
    sj = tl.refresh_products(sj)
    for name in ("SY", "YY", "Sg", "Yg"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)
    assert torch.equal(st.SY.diagonal(), st.sy_hist)


TRACE_CASES = {
    # 40 Rosenbrock iterations, none converges: every row is an iteration.
    "rosenbrock": ("rosenbrock", dict(max_iters=40, tol=0.0)),
    # The quadratic converges in a few iterations: the later rows are
    # frozen copies.
    "quadratic_frozen_rows": ("quadratic", dict(max_iters=25, tol=1e-8)),
    "refresh": ("rosenbrock", dict(max_iters=30, tol=0.0,
                                   direction="compact_incremental",
                                   refresh_interval=7)),
    "damping": ("rosenbrock", dict(max_iters=30, tol=0.0, damping=0.2)),
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_record_trace_matches_jax(case, monkeypatch):
    """Every Trace field of a traced ``minimize`` against the JAX
    package's: max_iters rows; alpha, the cumulative counters and guards
    equal; f and ||g|| to STEP_RTOL; rows at and beyond the final k frozen
    copies."""
    name, kw = TRACE_CASES[case]
    kw = dict(kw, record_trace=True)
    pj, pt = tl.get_problem(name), tt.get_problem(name)
    x0 = _x0(4)
    rj = tl.minimize(pj.f, jnp.asarray(x0), tl.LBFGSConfig(**kw),
                     grad=pj.grad)
    seen = _refresh_points(monkeypatch)
    rt = tt.minimize(pt.f, torch.from_numpy(x0), tt.LBFGSConfig(**kw),
                     grad=pt.grad)
    if case == "refresh":
        assert seen == [7, 14, 21, 28, 30]
    n, k = kw["max_iters"], rt.iterations.item()
    assert k == int(rj.iterations) and rt.status.item() == int(rj.status)
    assert isinstance(rt.trace, tt.Trace)
    assert tt.Trace._fields == tl.Trace._fields
    for field in tt.Trace._fields:
        a = getattr(rt.trace, field).numpy()
        b = np.asarray(getattr(rj.trace, field))
        assert a.shape == b.shape and a.shape[0] == n, field
        assert a.dtype == b.dtype, field
        if field in ("f", "g_norm"):
            np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=1e-14,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
        assert (a[k - 1:] == a[k - 1]).all(), field
    if case == "quadratic_frozen_rows":
        assert k < n
    np.testing.assert_array_equal(rt.trace.f[-1].numpy(), rt.f.numpy())
    back = interop.trace_from_numpy(interop.trace_to_numpy(rt.trace),
                                    device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, rt.trace))
    carried = interop.trace_from_numpy(
        {k_: np.asarray(v) for k_, v in rj.trace._asdict().items()},
        device="cpu")
    assert torch.equal(carried.alpha, rt.trace.alpha)


def test_trace_of_a_converged_start_is_all_frozen():
    p = tt.get_problem("quadratic")
    r = tt.minimize(p.f, torch.ones(8, dtype=torch.float64),
                    tt.LBFGSConfig(record_trace=True, max_iters=6),
                    grad=p.grad)
    assert r.iterations.item() == 0
    assert r.trace.f.shape == (6,) and r.trace.guards.shape == (6, tt.Guard.N)
    assert not r.trace.alpha.any() and (r.trace.n_fev == 1).all()


@pytest.mark.parametrize("kw", [dict(), dict(direction="compact_incremental",
                                             refresh_interval=4)])
def test_solve_segments_match_jax(kw):
    """A solve driven in segments of 6 iterations through
    ``make_solve_segment`` and closed by ``finalize_result``: each segment
    ends at the same k with a RUNNING status in both packages, and the
    result equals the JAX package's."""
    kw = dict(kw, max_iters=26, tol=0.0)
    cj, ct = tl.LBFGSConfig(**kw), tt.LBFGSConfig(**kw)
    pj, pt = _problems()
    seg_j = tl.make_solve_segment(cj, pj.f, grad=pj.grad, iters=6,
                                  donate=False)
    seg_t = tt.make_solve_segment(ct, pt.f, grad=pt.grad, iters=6)
    sj = tl.init_state(tl.make_value_and_grad(pj.f, pj.grad),
                       jnp.asarray(_x0(5)), cj.m)
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    ks = []
    while st.k.item() < ct.max_iters:
        sj, st = seg_j(sj), seg_t(st)
        assert st.status.item() == int(sj.status) == tt.Status.RUNNING
        ks.append(st.k.item())
        assert ks[-1] == int(sj.k)
    assert ks == [6, 12, 18, 24, 26]
    rj, rt = tl.finalize_result(cj, sj), tt.finalize_result(ct, st)
    assert rt.status.item() == int(rj.status) == tt.Status.MAX_ITERS
    assert rt.trace is None
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(rt.f.item(), float(rj.f), rtol=STEP_RTOL)


def test_segment_default_length_is_the_refresh_interval():
    ct = tt.LBFGSConfig(direction="compact_incremental", refresh_interval=4,
                        max_iters=10, tol=0.0)
    p = tt.get_problem("rosenbrock")
    seg = tt.make_solve_segment(ct, p.f, grad=p.grad)
    st = seg(tt.init_state(tt.make_value_and_grad(p.f, p.grad),
                           torch.from_numpy(_x0(6)), ct.m))
    assert st.k.item() == 4


# --- the gradient from autograd ---------------------------------------------

def beale_like_jax(x):
    a, b = x[::2], x[1::2]
    return jnp.sum((1.5 - a + a * b) ** 2 + (2.25 - a + a * b**2) ** 2)


def beale_like(x):
    a, b = x[..., ::2], x[..., 1::2]
    return torch.sum((1.5 - a + a * b) ** 2 + (2.25 - a + a * b**2) ** 2,
                     dim=-1)


def test_autograd_gradient_matches_jax_grad():
    x = np.random.default_rng(7).uniform(-2, 2, D)
    fj, gj = jax.value_and_grad(beale_like_jax)(jnp.asarray(x))
    vg = tt.make_value_and_grad(beale_like)
    xt = torch.from_numpy(x)
    f, g = vg(xt)
    # The same formula differentiated by two autodiff systems, float64.
    np.testing.assert_allclose(f.item(), float(fj), rtol=1e-13)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-12,
                               atol=1e-12)
    assert not f.requires_grad and not g.requires_grad
    assert not xt.requires_grad
    # A batch: each lane's gradient is its own row.
    xb = torch.from_numpy(np.random.default_rng(8).uniform(-2, 2, (3, D)))
    fb, gb = vg(xb)
    for lane in range(3):
        f1, g1 = vg(xb[lane])
        assert torch.equal(fb[lane], f1) and torch.equal(gb[lane], g1)


def test_autograd_builds_no_graph_in_the_solver():
    """The solver runs under no_grad: the state it returns carries no
    graph, the ring was written in place, and a trial in direct mode built
    none either."""
    seen = []

    def f(x):
        seen.append(torch.is_grad_enabled())
        return beale_like(x)

    r = tt.minimize(f, torch.zeros(16, dtype=torch.float64),
                    tt.LBFGSConfig(max_iters=5, tol=0.0))
    assert r.iterations.item() == 5
    assert not r.x.requires_grad and r.x.grad_fn is None
    assert True in seen and False in seen   # gradient calls, and trials


@pytest.mark.parametrize("kw", [
    dict(),                                              # LBFGSConfig()
    dict(line_search="wolfe_interpolation", c2=0.9, max_iters=500, tol=1e-6,
         fidelity="fixed"),                              # examples/02
])
def test_default_config_solves_with_autograd(kw):
    """``minimize(f, x0)`` with no gradient, in both packages: the same
    status and iteration count, f and x to rounding.  examples/02's
    objective, d = 64."""
    x0 = np.zeros(64)
    rj = tl.minimize(beale_like_jax, jnp.asarray(x0), tl.LBFGSConfig(**kw))
    rt = tt.minimize(beale_like, torch.from_numpy(x0), tt.LBFGSConfig(**kw))
    assert rt.status.item() == int(rj.status) == tt.Status.CONVERGED
    assert rt.iterations.item() == int(rj.iterations)
    assert rt.n_fev.item() == int(rj.n_fev)
    assert rt.n_gev.item() == int(rj.n_gev)
    np.testing.assert_allclose(rt.f.item(), float(rj.f), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-6,
                               atol=1e-8)


def test_reference_configs_solve():
    """REFERENCE_SEQUENTIAL and REFERENCE_PARALLEL have direction
    "two_loop": both now solve, as the JAX package's do."""
    pj, pt = _problems()
    x0 = _x0(9, 64)
    for name in ("REFERENCE_SEQUENTIAL", "REFERENCE_PARALLEL"):
        cj = getattr(tl, name).replace(max_iters=60)
        ct = getattr(tt, name).replace(max_iters=60)
        rj = tl.minimize(pj.f, jnp.asarray(x0), cj, grad=pj.grad)
        rt = tt.minimize(pt.f, torch.from_numpy(x0), ct, grad=pt.grad)
        assert rt.iterations.item() == int(rj.iterations), name
        assert rt.status.item() == int(rj.status), name
        np.testing.assert_allclose(rt.f.item(), float(rj.f), rtol=1e-6)


def test_accurate_dots_rejects_a_plain_fused_tail():
    p = tt.get_problem("rosenbrock")
    cfg = tt.LBFGSConfig(accurate_dots=True, direction="compact_incremental",
                         ls_eval="polynomial", max_iters=3)
    with pytest.raises(ValueError, match="accurate_dots"):
        tt.minimize(p.f, torch.from_numpy(_x0()), cfg, grad=p.grad,
                    dir_poly=p.dir_poly,
                    fused_tail=tt.fused_tail_for("rosenbrock"))


# --- compensated dots -------------------------------------------------------

def test_compensated_dot_beats_plain_f32():
    """tests/test_utils.py's adversarial case: large cancelling values and
    a small signal.  The compensated float32 dot is at least as close to
    the float64 truth as the plain one, and within 1e-3 of the JAX
    package's compensated_dot relative to the truth."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    a64 = rng.normal(size=n) * 1e6 + rng.normal(size=n)
    b64 = rng.normal(size=n)
    exact = float(np.dot(a64, b64))
    a32, b32 = a64.astype(np.float32), b64.astype(np.float32)
    at, bt = torch.from_numpy(a32), torch.from_numpy(b32)
    plain = torch.dot(at, bt).item()
    comp = compensated_dot(at, bt).item()
    ref = float(jax_compensated_dot(jnp.asarray(a32), jnp.asarray(b32)))
    assert abs(comp - exact) <= abs(plain - exact) + 1e-3 * abs(exact)
    assert abs(comp - ref) <= 1e-3 * abs(exact)


@pytest.mark.parametrize("n", [3, 1000, 1024, 10000, 70001])
def test_compensated_dot_matches_jax_f64(n):
    """float64 against the JAX package's compensated_dot: both return the
    sum of the same chunk partials compensated, so they agree to a few
    units in the last place of sum |terms| (1e-14 of it)."""
    rng = np.random.default_rng(n)
    a, b = rng.normal(size=n) * 10.0 ** rng.integers(-3, 4, n), \
        rng.normal(size=n)
    ref = float(jax_compensated_dot(jnp.asarray(a), jnp.asarray(b)))
    got = compensated_dot(torch.from_numpy(a), torch.from_numpy(b)).item()
    assert abs(got - ref) <= 1e-14 * np.abs(a * b).sum()
    assert compensated_norm_sq(torch.from_numpy(a)).item() == pytest.approx(
        float(np.dot(a, a)), rel=1e-14)


def test_compensated_dot_small_exact_and_stacked():
    a = torch.tensor([1.0, 2.0, 3.0])
    b = torch.tensor([4.0, 5.0, 6.0])
    assert compensated_dot(a, b).item() == 32.0
    rng = np.random.default_rng(1)
    A = torch.from_numpy(rng.normal(size=(4, 3000)))
    B = torch.from_numpy(rng.normal(size=(4, 3000)))
    stacked = compensated_dot(A, B)
    for i in range(4):
        assert torch.equal(stacked[i], compensated_dot(A[i], B[i]))


def test_compensated_sum_recovers_lost_bits():
    """1 + n tiny terms: a plain float32 sum in order drops every tiny
    term; the compensated sum keeps them."""
    from tpu_lbfgs_torch.utils.accurate import _compensated_sum

    parts = torch.full((1000,), 1e-9, dtype=torch.float32)
    parts[0] = 1.0
    exact = 1.0 + 999e-9
    got = _compensated_sum(parts).item()
    assert abs(got - exact) <= 2 ** -24
    assert got > 1.0


# --- problems, fixtures, the SciPy front end --------------------------------

def test_problem_registry_mirrors_reference():
    assert tt.problem_names() == tl.problem_names()
    p = tt.Problem(name="beale_like_torch", f=beale_like,
                   grad=lambda x: tt.make_value_and_grad(beale_like)(x)[1])
    tt.register_problem(p)
    try:
        assert tt.get_problem("beale_like_torch") is p
        assert "beale_like_torch" in tt.problem_names()
    finally:
        from tpu_lbfgs_torch.problems import suite
        del suite._PROBLEMS["beale_like_torch"]
    for name in tl.problem_names():
        mj = np.asarray(tl.get_problem(name).minimizer(5, jnp.float64))
        mt = tt.get_problem(name).minimizer(5, torch.float64, device="cpu")
        np.testing.assert_array_equal(mt.numpy(), mj)
        assert tt.get_problem(name).f(mt).item() == 0.0


def test_coupled_quadratic_solves_as_jax():
    pj, pt = tl.get_problem("coupled_quadratic"), \
        tt.get_problem("coupled_quadratic")
    x0 = np.random.default_rng(10).uniform(-1, 1, D)
    kw = dict(max_iters=100, tol=1e-6)
    rj = tl.minimize(pj.f, jnp.asarray(x0), tl.LBFGSConfig(**kw),
                     grad=pj.grad)
    rt = tt.minimize(pt.f, torch.from_numpy(x0), tt.LBFGSConfig(**kw),
                     grad=pt.grad)
    assert rt.status.item() == int(rj.status) == tt.Status.CONVERGED
    assert rt.iterations.item() == int(rj.iterations)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), atol=1e-9)
    # batched, on the polynomial: each lane as the single solve
    xb = torch.from_numpy(np.random.default_rng(11).uniform(-1, 1, (3, D)))
    cfg = tt.LBFGSConfig(ls_eval="polynomial", direction="compact",
                         max_iters=8, tol=0.0)
    rb = tt.vmap_minimize(pt.f, xb, cfg, grad=pt.grad, dir_poly=pt.dir_poly,
                          lockstep="bounded")
    for lane in range(3):
        r1 = tt.minimize(pt.f, xb[lane], cfg, grad=pt.grad,
                         dir_poly=pt.dir_poly)
        np.testing.assert_allclose(rb.x[lane].numpy(), r1.x.numpy(),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dim", [2, 10, 50])
def test_fixtures_match_jax(dim):
    """One (dim, seed, condition) names the same matrix in both packages;
    f and grad agree to float64 rounding; the solve reaches the known
    minimizer."""
    fj = jax_fixtures.make_spd_fixture(dim, seed=3, condition=50.0)
    ft = fixtures.make_spd_fixture(dim, seed=3, condition=50.0)
    for name in ("A", "b", "minimizer"):
        np.testing.assert_array_equal(getattr(ft, name), getattr(fj, name))
    assert ft.minimum_value == fj.minimum_value
    pj, pt = fj.problem(), ft.problem(device="cpu")
    assert pt.name == pj.name
    x = np.random.default_rng(dim).normal(size=dim)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(pt.f(xt).item(), float(pj.f(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pt.grad(xt).numpy(),
                               np.asarray(pj.grad(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(
        pt.minimizer(dim, torch.float64, device="cpu").numpy(), ft.minimizer)
    # tol = 1e-6: tighter, the last iterations run on rounding and the two
    # packages stop a few iterations apart.
    kw = dict(max_iters=200, tol=1e-6, fidelity="fixed")
    r = tt.minimize(pt.f, torch.zeros(dim, dtype=torch.float64),
                    tt.LBFGSConfig(**kw), grad=pt.grad)
    rj = tl.minimize(pj.f, jnp.zeros(dim), tl.LBFGSConfig(**kw),
                     grad=pj.grad)
    assert r.status.item() == int(rj.status) == tt.Status.CONVERGED
    assert r.iterations.item() == int(rj.iterations)
    np.testing.assert_allclose(r.x.numpy(), ft.minimizer, atol=1e-5)
    np.testing.assert_allclose(r.f.item(), ft.minimum_value, atol=1e-10)


def test_fixture_suite_dims():
    assert fixtures.FIXTURE_DIMS == jax_fixtures.FIXTURE_DIMS
    suite = fixtures.fixture_suite(seed=1, dims=(2, 3))
    assert [fx.dim for fx in suite] == [2, 3]


def test_entry_points_without_a_tensor_need_a_cuda_device():
    """scipy_compat.minimize with a numpy or list x0, the fixtures,
    Problem.minimizer and interop's state_from_numpy and trace_from_numpy
    run on the current CUDA device and raise without one; device="cpu" asks
    for the CPU; a tensor x0 is solved where it lies."""
    p = tt.get_problem("quadratic")
    fx = fixtures.make_spd_fixture(3)
    arrays = interop.state_to_numpy(tt.init_state(
        tt.make_value_and_grad(p.f, p.grad), torch.zeros(4), 3))
    trace = {name: np.zeros(2) for name in tt.Trace._fields}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.state_from_numpy(arrays)
        with pytest.raises(RuntimeError, match="CUDA"):
            interop.trace_from_numpy(trace)
        with pytest.raises(RuntimeError, match="CUDA"):
            scipy_compat.minimize(p.f, np.zeros(4), jac=p.grad)
        with pytest.raises(RuntimeError, match="CUDA"):
            scipy_compat.minimize(p.f, [0.0, 0.0], jac=p.grad)
        with pytest.raises(RuntimeError, match="CUDA"):
            fx.problem()
        with pytest.raises(RuntimeError, match="CUDA"):
            p.minimizer(4, torch.float64)
    res = scipy_compat.minimize(p.f, [0.0, 0.0], jac=p.grad, device="cpu")
    assert res.success and res.x.dtype == np.float32
    res = scipy_compat.minimize(p.f, torch.zeros(4, dtype=torch.float64),
                                jac=p.grad)
    assert res.success and res.x.dtype == np.float64
    assert fx.problem(device="cpu").f(torch.zeros(
        3, dtype=torch.float64)).device.type == "cpu"
    assert interop.state_from_numpy(arrays, device="cpu").x.device.type \
        == "cpu"
    assert interop.trace_from_numpy(trace, device="cpu").f.device.type \
        == "cpu"


SCIPY_CASES = {
    "jac": dict(jac="grad"),
    "autodiff": dict(jac=None),
    "jac_true": dict(jac=True),
    "options": dict(jac="grad", options={"maxiter": 7, "gtol": 1e-9,
                                         "maxcor": 5,
                                         "linesearch": "backtracking_wolfe",
                                         "c2": 0.9, "damping": 0.2}),
    "tol": dict(jac="grad", tol=1e-3),
    "config": dict(jac="grad", config=dict(max_iters=9, tol=0.0,
                                           direction="compact")),
}


@pytest.mark.parametrize("case", sorted(SCIPY_CASES))
def test_scipy_compat_matches_jax(case):
    kw = dict(SCIPY_CASES[case])
    pj, pt = _problems()
    x0 = _x0(12, 32)
    kj, kt = dict(kw), dict(kw)
    if kw["jac"] == "grad":
        kj["jac"], kt["jac"] = pj.grad, pt.grad
    fun_j, fun_t = pj.f, pt.f
    if kw["jac"] is True:
        fun_j, fun_t = pj.value_and_grad, pt.value_and_grad
    if "config" in kw:
        kj["config"] = tl.LBFGSConfig(**kw["config"])
        kt["config"] = tt.LBFGSConfig(**kw["config"])
    rj = jax_scipy.minimize(fun_j, x0, **kj)
    rt = scipy_compat.minimize(fun_t, x0, device="cpu", **kt)
    assert (rt.nit, rt.nfev, rt.njev, rt.status, rt.success, rt.message) == \
        (rj.nit, rj.nfev, rj.njev, rj.status, rj.success, rj.message)
    assert isinstance(rt.x, np.ndarray) and rt["x"] is rt.x
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-6, atol=1e-8)
    # ||g|| at the point where the solve stops is what is left of the
    # gradient after cancellation: rounding shows in it first.
    np.testing.assert_allclose(rt.extra["g_norm"], rj.extra["g_norm"],
                               rtol=0.1, atol=1e-12)


def test_scipy_compat_args_warnings_and_errors():
    def fun(x, c):
        return torch.sum((x - c) ** 2)

    def jac(x, c):
        return 2.0 * (x - c)

    x0 = np.zeros(6)
    res = scipy_compat.minimize(fun, x0, args=(3.0,), jac=jac, device="cpu")
    assert res.success
    np.testing.assert_allclose(res.x, 3.0, atol=1e-6)
    res = scipy_compat.minimize(lambda x, c: (fun(x, c), jac(x, c)), x0,
                                args=(3.0,), jac=True, device="cpu")
    np.testing.assert_allclose(res.x, 3.0, atol=1e-6)
    with pytest.warns(RuntimeWarning, match="ignores unsupported"):
        scipy_compat.minimize(fun, x0, args=(1.0,), jac=jac, device="cpu",
                              options={"ftol": 1e-9, "maxls": 20})
    with pytest.warns(RuntimeWarning, match="finite differences"):
        res = scipy_compat.minimize(fun, x0, args=(1.0,), jac="2-point",
                                    method="L-BFGS-B", device="cpu")
    assert res.success
    with pytest.raises(ValueError, match="unsupported method"):
        scipy_compat.minimize(fun, x0, method="bfgs", device="cpu")


# --- batches with the options of this slice ---------------------------------

BATCH_CASES = {
    "two_loop": dict(direction="two_loop"),
    "compact": dict(direction="compact"),
    "damping": dict(direction="compact_incremental", damping=0.2),
    "accurate_dots": dict(direction="compact", accurate_dots=True),
    "refresh": dict(direction="compact_incremental", refresh_interval=5),
}


@pytest.mark.parametrize("lockstep", ["while", "bounded"])
@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batched_options_match_vmap(case, lockstep):
    """A batch (B = 4, d = 64, polynomial backtracking) under each option
    against the JAX package's vmap_minimize: per lane equal iterations,
    status, counters and guards; f to STEP_RTOL over 20 iterations."""
    kw = dict(BATCH_CASES[case], ls_eval="polynomial", max_iters=20, tol=0.0)
    pj, pt = _problems()
    x0 = np.stack([_x0(20 + i, 64) for i in range(4)])
    from tpu_lbfgs.batch.vmapped import vmap_minimize as jax_vmap_minimize
    rj = jax_vmap_minimize(pj.f, jnp.asarray(x0), tl.LBFGSConfig(**kw),
                           grad=pj.grad, dir_poly=pj.dir_poly,
                           lockstep=lockstep)
    rt = tt.vmap_minimize(pt.f, torch.from_numpy(x0), tt.LBFGSConfig(**kw),
                          grad=pt.grad, dir_poly=pt.dir_poly,
                          lockstep=lockstep)
    for name in ("iterations", "status", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(rt.f.numpy(), np.asarray(rj.f),
                               rtol=STEP_RTOL)
    if case == "damping":
        assert rt.guards[:, tt.Guard.DAMPED].sum().item() > 0


def test_batched_trace_matches_vmap():
    """record_trace under lockstep "while": a per-lane trace, (B,
    max_iters, ...), lanes that converge early frozen from their own k."""
    kw = dict(ls_eval="polynomial", direction="compact_incremental",
              record_trace=True, max_iters=12, tol=1e-6)
    pj, pt = tl.get_problem("quadratic"), tt.get_problem("quadratic")
    x0 = np.stack([_x0(30, 16), np.ones(16), _x0(31, 16) * 40.0])
    from tpu_lbfgs.batch.vmapped import vmap_minimize as jax_vmap_minimize
    rj = jax_vmap_minimize(pj.f, jnp.asarray(x0), tl.LBFGSConfig(**kw),
                           grad=pj.grad, dir_poly=pj.dir_poly)
    rt = tt.vmap_minimize(pt.f, torch.from_numpy(x0), tt.LBFGSConfig(**kw),
                          grad=pt.grad, dir_poly=pt.dir_poly)
    np.testing.assert_array_equal(rt.iterations.numpy(),
                                  np.asarray(rj.iterations))
    assert rt.iterations[1].item() == 0
    for field in tt.Trace._fields:
        a = getattr(rt.trace, field).numpy()
        b = np.asarray(getattr(rj.trace, field))
        assert a.shape == b.shape and a.shape[:2] == (3, 12), field
        if field in ("f", "g_norm"):
            np.testing.assert_allclose(a, b, rtol=STEP_RTOL, atol=1e-12,
                                       err_msg=field)
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)
