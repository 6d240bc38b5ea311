"""The fused kernels of the whole problem suite against the JAX package, on
the CPU: the quadratic and coupled bodies, the fused tail's in-kernel
history products and compensated sums, and a bfloat16 history ring.

On the CPU the port's wrappers run their plain PyTorch versions and the JAX
package's Pallas kernels run in interpret mode (tests/conftest.py forces
the cpu backend), so part (a) holds each plain version to its Pallas
kernel; chip_smoke.py holds the CUDA kernels to the plain versions on the
GPU.  Part (b) runs solves through ``fused_tail_for`` and
``fused_value_and_grad`` in both packages.  Inputs come from numpy.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.kernels.pallas_ops import FUSED_VG as JAX_FUSED_VG
from tpu_lbfgs.kernels.pallas_ops import (
    _combine_jnp,
    _combine_pallas,
    _fused_tail_pallas,
    _hist3,
    _multi_phi_dphi_pallas,
    _multi_phi_pallas,
)
from tpu_lbfgs_torch import interop, kernels
from tpu_lbfgs_torch.kernels import fused_ops

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

BODIES = ["quadratic", "rosenbrock", "coupled_quadratic"]
NEW_BODIES = ["quadratic", "coupled_quadratic"]
# Pallas (interpret mode) against the plain version, both float32: the two
# sum in different orders and accumulators (float32 blocks there, float64
# here), so the tolerances are those of the reference's own Pallas-vs-jnp
# test (tests/test_tail_fused.py::test_pallas_matches_jnp).
RTOL_F32, ATOL_F32 = 2e-5, 1e-4
TAIL_NAMES = ["x_new", "f_new", "g_new", "s_row", "y_row",
              "sy", "yy", "gg", "dgn", "ggn", "ygn", "t1", "t2"]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tail_inputs(d, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, d).astype(np.float32)
    dv = rng.uniform(-1, 1, d).astype(np.float32)
    g = rng.uniform(-1, 1, d).astype(np.float32)
    S = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    Y = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    return x, dv, np.float32(0.37), g, S, Y


def _f32(a):
    """A JAX or torch array (bfloat16 included) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


# --- (a) plain versions against the interpreted Pallas kernels --------------

@pytest.mark.parametrize("d", [1152, 4096])
@pytest.mark.parametrize("problem", NEW_BODIES)
def test_fused_vg_matches_pallas(problem, d):
    x = _tail_inputs(d, 1)[0]
    f_ref, g_ref = JAX_FUSED_VG[problem](jnp.asarray(x), use_pallas=True)
    f, g = tt.fused_value_and_grad(problem)(torch.from_numpy(x))
    assert f.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(f.item(), float(f_ref), rtol=RTOL_F32,
                               atol=ATOL_F32)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=RTOL_F32,
                               atol=ATOL_F32)
    # use_pallas=False is the same plain version; f and the gradient are
    # the problem's own to rounding.
    f_p, g_p = tt.fused_value_and_grad(problem, use_pallas=False)(
        torch.from_numpy(x))
    assert torch.equal(f_p, f) and torch.equal(g_p, g)
    p = tt.get_problem(problem)
    xd = torch.from_numpy(x).double()
    np.testing.assert_allclose(f.item(), p.f(xd).item(), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), p.grad(xd).numpy(), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("with_matvec", [False, True])
@pytest.mark.parametrize("hdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("problem", BODIES)
def test_fused_tail_plain_matches_pallas(problem, hdtype, with_matvec,
                                         accurate):
    """The plain fused tail against the interpreted Pallas kernel, each
    body, float32 and bfloat16 ring, with and without the in-kernel history
    products, plain and compensated: RTOL_F32 / ATOL_F32 on every output,
    the rows compared as float32 (d = 1152 is no multiple of the Pallas
    block, so its padding is exercised)."""
    d, m = 1152, 5
    x, dv, alpha, g, S, Y = _tail_inputs(d, m, seed=1)
    Sj = jnp.asarray(S).astype(hdtype)
    Yj = jnp.asarray(Y).astype(hdtype)
    ref = _fused_tail_pallas(problem, jnp.asarray(x), jnp.asarray(dv),
                             jnp.asarray(alpha), jnp.asarray(g), Sj, Yj,
                             with_matvec, accurate=accurate)
    t = torch.from_numpy
    St, Yt = (t(a).to(TORCH_DTYPE[hdtype]) for a in (S, Y))
    assert np.array_equal(_f32(St), _f32(Sj))     # both round to nearest even
    tail = tt.fused_tail_for(problem, with_matvec=with_matvec,
                             accurate_dots=accurate)
    assert tail.accurate_dots == accurate
    out = tail(t(x), t(dv), torch.tensor(alpha), t(g), St, Yt)
    assert len(out) == len(ref) == len(TAIL_NAMES)
    for name, a, b in zip(TAIL_NAMES, out, ref):
        if b is None:
            assert a is None and not with_matvec, name
            continue
        want = TORCH_DTYPE[hdtype] if name in ("s_row", "y_row") \
            else torch.float32
        assert a.dtype == want, name
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=RTOL_F32,
                                   atol=ATOL_F32, err_msg=name)


@pytest.mark.parametrize("problem", BODIES)
def test_fused_tail_matvec_at_m10(problem):
    """m = 10 at d = 4096, bfloat16 ring: t1 and t2 against the interpreted
    kernel (RTOL_F32 / ATOL_F32), and against the exact float64 products of
    the widened ring (the plain version adds them in float64: 1e-6
    relative to sum |terms|)."""
    d, m = 4096, 10
    x, dv, alpha, g, S, Y = _tail_inputs(d, m, seed=2)
    Sj, Yj = (jnp.asarray(a).astype(jnp.bfloat16) for a in (S, Y))
    ref = _fused_tail_pallas(problem, jnp.asarray(x), jnp.asarray(dv),
                             jnp.asarray(alpha), jnp.asarray(g), Sj, Yj, True)
    t = torch.from_numpy
    St, Yt = t(S).bfloat16(), t(Y).bfloat16()
    out = tt.fused_tail_for(problem, with_matvec=True)(
        t(x), t(dv), torch.tensor(alpha), t(g), St, Yt)
    y = (out[2] - t(g)).double()            # the raw float32 y
    for i, hist in ((11, St), (12, Yt)):
        assert out[i].dtype == torch.float32 and out[i].shape == (m,)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(ref[i]),
                                   rtol=RTOL_F32, atol=ATOL_F32)
        exact = hist.double() @ y
        scale = (hist.double().abs() @ y.abs()).numpy()
        assert (np.abs(out[i].double().numpy() - exact.numpy())
                <= 1e-6 * scale).all()


def test_fused_tail_plain_keeps_the_rosenbrock_case():
    """The case bench.py's solve runs every iteration (Rosenbrock, no
    matvec, float32, plain sums) is what it was: the composition of the
    plain value-and-gradient, rows in the iterate's dtype, no t1 / t2, and
    it does not read the ring."""
    x, dv, alpha, g, S, Y = (torch.from_numpy(np.asarray(v))
                             for v in _tail_inputs(515, 3, seed=3))
    out = fused_ops.fused_tail_rosenbrock(x, dv, alpha, g, S, Y)
    s = alpha * dv
    f_new, g_new = fused_ops.rosenbrock_vg_plain(x + s)
    assert torch.equal(out[0], x + s) and torch.equal(out[1], f_new)
    assert torch.equal(out[2], g_new) and torch.equal(out[3], s)
    assert torch.equal(out[4], g_new - g)
    assert out[11] is None and out[12] is None
    again = tt.fused_tail_for("rosenbrock")(x, dv, alpha, g, None, None)
    assert all(torch.equal(a, b) for a, b in zip(out[:11], again[:11]))


def _trial_inputs(d, K, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, d).astype(np.float32)
    dv = rng.uniform(-1, 1, d).astype(np.float32)
    alphas = (2.0 ** rng.integers(-6, 2, K)
              * rng.uniform(0.5, 1.0, K)).astype(np.float32)
    return x, dv, alphas


@pytest.mark.parametrize("K", [8, 36])
@pytest.mark.parametrize("problem", NEW_BODIES)
def test_multi_phi_plain_matches_pallas(problem, K):
    """f at K trial points against the interpreted Pallas kernel, d = 1152:
    every term is >= 0, so each sum is held to 1e-5 relative (float32
    accumulators there, float64 here)."""
    x, dv, alphas = _trial_inputs(1152, K, seed=4)
    ref = np.asarray(_multi_phi_pallas(problem, *map(jnp.asarray,
                                                     (x, dv, alphas))))
    out = tt.multi_phi_for(problem)(*map(torch.from_numpy, (x, dv, alphas)))
    assert out.shape == (K,) and out.dtype == torch.float32
    if problem == "quadratic":
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    else:       # the cross terms x_i x_{i+1} have either sign
        xt, dt = torch.from_numpy(x).double(), torch.from_numpy(dv).double()
        u = xt + torch.from_numpy(alphas).double()[:, None] * dt
        scale = (1000.0 * u * u).sum(-1) + (100.0 * u[:, :-1]
                                            * u[:, 1:]).abs().sum(-1)
        assert (np.abs(out.numpy() - ref) <= 1e-5 * scale.numpy()).all()


@pytest.mark.parametrize("K", [8, 36])
@pytest.mark.parametrize("problem", NEW_BODIES)
def test_multi_phi_dphi_plain_matches_pallas(problem, K):
    """(f, grad f . d) at K trial points against the interpreted Pallas
    kernel, d = 1152: each sum within 1e-5 of the sum of |terms|."""
    x, dv, alphas = _trial_inputs(1152, K, seed=5)
    f_ref, g_ref = (np.asarray(a) for a in _multi_phi_dphi_pallas(
        problem, *map(jnp.asarray, (x, dv, alphas))))
    f, gd = tt.multi_phi_dphi_for(problem)(
        *map(torch.from_numpy, (x, dv, alphas)))
    assert f.shape == gd.shape == (K,) and gd.dtype == torch.float32
    xt, dt = torch.from_numpy(x).double(), torch.from_numpy(dv).double()
    u = xt + torch.from_numpy(alphas).double()[:, None] * dt
    p = tt.get_problem(problem)
    g_scale = (p.grad(u) * dt).abs().sum(-1).numpy()
    f_scale = (1000.0 * u * u).sum(-1).numpy() * 1.1 \
        if problem == "coupled_quadratic" else p.f(u).numpy()
    assert (np.abs(f.numpy() - f_ref) <= 1e-5 * f_scale).all()
    assert (np.abs(gd.numpy() - g_ref) <= 1e-5 * g_scale).all()
    # phi of multi_phi_dphi is multi_phi's, bit for bit.
    assert torch.equal(f, tt.multi_phi_for(problem)(
        *map(torch.from_numpy, (x, dv, alphas))))


@pytest.mark.parametrize("m", [5, 10])
@pytest.mark.parametrize("d", [1152, 4096])
def test_combine_direction_bf16_ring_matches_pallas(d, m):
    """The combine over a bfloat16 ring.  The plain version runs the Pallas
    kernel's order with float32 coefficients and the ring widened: 1e-6 of
    the largest entry against the interpreted kernel (a fused multiply-add's
    rounding per row).  The matrix-vector route casts the coefficients down
    to bfloat16, as the reference's _combine_jnp does: 1e-5 against it."""
    rng = np.random.default_rng(m)
    g = rng.normal(size=d).astype(np.float32)
    S, Y = (rng.normal(size=(m, d)).astype(np.float32) for _ in range(2))
    v, u = (rng.normal(size=m).astype(np.float32) for _ in range(2))
    gamma = np.float32(0.8)
    Sj, Yj = (_hist3(jnp.asarray(a).astype(jnp.bfloat16)) for a in (S, Y))
    jargs = (jnp.asarray(g), Sj, Yj, jnp.asarray(v), jnp.asarray(u),
             jnp.asarray(gamma))
    ref_kernel = np.asarray(_combine_pallas(*jargs))
    ref_matmul = np.asarray(_combine_jnp(*jargs))
    t = torch.from_numpy
    args = (t(g), t(S).bfloat16(), t(Y).bfloat16(), t(v), t(u),
            torch.tensor(gamma))
    scale = np.abs(ref_kernel).max()
    plain = fused_ops.combine_direction_plain(*args)
    assert plain.dtype == torch.float32 and plain.shape == (d,)
    np.testing.assert_allclose(plain.numpy(), ref_kernel, rtol=0,
                               atol=1e-6 * scale)
    assert torch.equal(kernels.combine_direction(*args, use_pallas=True),
                       plain)
    routed = kernels.combine_direction(*args, use_pallas=False)
    assert routed.dtype == torch.float32
    np.testing.assert_allclose(routed.numpy(), ref_matmul, rtol=0,
                               atol=1e-5 * scale)


def test_suite_factories_mirror_the_reference():
    """No suite problem raises; ``sphere`` has no kernel body in either
    package and takes the plain composition; the auto rule and the
    history-dtype rule keep the reference's signatures."""
    import inspect

    for name in tt.problem_names():
        tt.fused_value_and_grad(name)
        tt.multi_phi_for(name)
        tt.multi_phi_dphi_for(name)
        for mv in ("auto", True, False):
            tail = tt.fused_tail_for(name, with_matvec=mv, m=10, d=4096,
                                     history_dtype="bfloat16",
                                     accurate_dots=True)
            assert tail.accurate_dots is True
    assert set(fused_ops.FUSED_VG) == set(JAX_FUSED_VG) == set(BODIES)
    assert tt.fused_value_and_grad("sphere") == \
        tt.get_problem("sphere").value_and_grad
    for ours, theirs in (
            (tt.fused_tail_for, tl.fused_tail_for),
            (tt.auto_with_matvec, tl.problems.suite.auto_with_matvec),
            (tt.resolve_history_dtype, tl.core.solver.resolve_history_dtype),
            (kernels.make_fused_tail, tl.kernels.make_fused_tail),
            (kernels.make_multi_phi, tl.kernels.make_multi_phi),
            (kernels.make_multi_phi_dphi, tl.kernels.make_multi_phi_dphi)):
        assert list(inspect.signature(ours).parameters) == \
            list(inspect.signature(theirs).parameters), ours.__name__
    # The port's own rules (measured on an H100, problems/suite.py): the
    # products go into the tail for a float32 or bfloat16 ring at any depth,
    # from d = 2^16 on, one instance; "auto" history is the iterate's dtype.
    assert tt.auto_with_matvec(10, 1 << 20) is True
    assert tt.auto_with_matvec(10, 1 << 24, "float32") is True
    assert tt.auto_with_matvec(10, 1 << 16, torch.float32) is True
    for m in (5, 10, 20):
        assert tt.auto_with_matvec(m, 1 << 20, "bfloat16") is True
    assert tt.auto_with_matvec(10, 1 << 20, torch.bfloat16) is True
    assert tt.auto_with_matvec(7, 1 << 20, "bfloat16") is True
    assert tt.auto_with_matvec(10, (1 << 16) - 1, "float32") is False
    assert tt.auto_with_matvec(10, 4096, "bfloat16") is False
    assert tt.auto_with_matvec(10, 1 << 20, "float64") is False
    assert tt.auto_with_matvec(10, 1 << 20, "bfloat16", batch=8) is False
    assert tt.resolve_history_dtype("auto", 10, 1 << 26, torch.float32) is None
    assert tt.resolve_history_dtype("bfloat16", 10, 64, torch.float32) \
        == "bfloat16"
    assert tt.resolve_history_dtype(None, 10, 64, torch.float32) is None
    assert tt.resolve_history_dtype("auto", 10, 1 << 20, torch.float64) is None


def test_cpu_suite_run_launches_no_kernel():
    """On the CPU every wrapper of the suite takes its plain version."""
    kernels.reset_launches()
    for name in BODIES:
        p = tt.get_problem(name)
        cfg = tt.LBFGSConfig(line_search="backtracking_speculative",
                             direction="compact_incremental", use_pallas=True,
                             max_iters=2, tol=0.0)
        tt.minimize(p.f, torch.full((128,), -1.2), cfg,
                    value_and_grad=tt.fused_value_and_grad(name),
                    fused_tail=tt.fused_tail_for(name, with_matvec=True),
                    phi_batch=tt.multi_phi_for(name))
    counts = kernels.launch_counts()
    assert not any(counts.values())
    assert {f"{b}_{k}" for b in BODIES for k in (
        "vg", "fused_tail", "multi_phi", "multi_phi_dphi")} <= set(counts)


def test_kernel_wrappers_refuse_what_they_cannot_take():
    """Off the CPU a wrapper of a problem with a body launches its kernel
    or raises; nothing gives way to the plain version."""
    x = torch.zeros(16, device="meta")
    a = torch.zeros((), device="meta")
    H = torch.zeros(10, 16, device="meta")
    for name in BODIES:
        with pytest.raises(ValueError, match="CUDA"):
            tt.fused_value_and_grad(name)(x)
        with pytest.raises(ValueError, match="CUDA"):
            tt.fused_tail_for(name, with_matvec=True)(x, x, a, x, H, H)
        with pytest.raises(ValueError, match="CUDA"):
            tt.multi_phi_for(name)(x, x, torch.zeros(8, device="meta"))
        with pytest.raises(ValueError, match="CUDA"):
            tt.multi_phi_dphi_for(name)(x, x, torch.zeros(8, device="meta"))


# --- (b) solves through the suite's factories, against tpu_lbfgs ------------

def _np_state(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _x0(problem, d, seed):
    rng = np.random.default_rng(seed)
    if problem == "rosenbrock":     # the classic start, jittered
        return -1.2 + rng.uniform(-0.1, 0.1, d)
    return rng.uniform(-2.0, 2.0, d)


def _steppers(problem, cfg_kw, tail_kw):
    """One jitted JAX iterate and one port iterate through the same
    factories, and the JAX value-and-gradient for init_state."""
    pj, pt = tl.get_problem(problem), tt.get_problem(problem)
    cfg_j, cfg_t = tl.LBFGSConfig(**cfg_kw), tt.LBFGSConfig(**cfg_kw)
    vg_j = tl.fused_value_and_grad(problem, use_pallas=True)
    tail_j = tl.fused_tail_for(problem, use_pallas=True, **tail_kw)
    vg_t = tt.fused_value_and_grad(problem)
    tail_t = tt.fused_tail_for(problem, **tail_kw)
    step_j = jax.jit(lambda s: tl.iterate(cfg_j, pj.f, vg_j, s, pj.dir_poly,
                                          tail_j))

    def step_t(s):
        return tt.iterate(cfg_t, pt.f, vg_t, s, pt.dir_poly, tail_t)

    return vg_j, step_j, step_t


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-300)


F64_CASES = {
    # name: (cfg overrides, fused_tail_for overrides)
    "matvec": ({}, dict(with_matvec=True)),
    "no_matvec": ({}, dict(with_matvec=False)),
    "accurate": (dict(accurate_dots=True),
                 dict(with_matvec=True, accurate_dots=True)),
    "damping": (dict(damping=0.2), dict(with_matvec=True)),
    "damping_two_loop": (dict(damping=0.2, direction="two_loop"),
                         dict(with_matvec=False)),
}
ITERS = {"rosenbrock": 40, "coupled_quadratic": 6, "quadratic": 2,
         "sphere": 2}


@pytest.mark.parametrize("case", list(F64_CASES))
@pytest.mark.parametrize("problem", ["rosenbrock", "coupled_quadratic",
                                     "quadratic", "sphere"])
def test_f64_fused_solve_matches_jax(problem, case):
    """float64 iterations through ``fused_tail_for`` +
    ``fused_value_and_grad`` (the reference takes its jnp route in float64,
    the port its plain versions), from one state: equal alpha, status,
    n_pairs and guard counters at every iteration; f and g_norm within
    1e-9 relative or 100x the JAX package's own deviation from a start
    moved by one ulp, whichever is larger (the amplification argument of
    tests/test_torch_solver.py::test_f64_trajectory_matches_jax), with a
    floor of 1e-13 of the starting value: the quadratics reach their
    minimum, where f is rounding residue."""
    d = 293
    cfg_over, tail_kw = F64_CASES[case]
    cfg_kw = {**dict(line_search="backtracking",
                     direction="compact_incremental", m=5, use_pallas=True,
                     ls_eval="polynomial"), **cfg_over}
    vg_j, step_j, step_t = _steppers(problem, cfg_kw, tail_kw)
    x0 = _x0(problem, d, seed=7)
    x1 = x0.copy()
    x1[::7] = np.nextafter(x1[::7], np.inf)
    sj = tl.init_state(vg_j, jnp.asarray(x0), cfg_kw["m"])
    sp = tl.init_state(vg_j, jnp.asarray(x1), cfg_kw["m"])
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    floor = {name: 1e-13 * float(getattr(sj, name))
             for name in ("f", "g_norm")}
    damped = 0
    for k in range(ITERS[problem]):
        sj, sp, st = step_j(sj), step_j(sp), step_t(st)
        assert st.alpha.item() == float(sj.alpha), k
        assert st.status.item() == int(sj.status), k
        assert st.n_pairs.item() == int(sj.n_pairs), k
        assert st.guards.tolist() == np.asarray(sj.guards).tolist(), k
        for name in ("f", "g_norm"):
            ref = float(getattr(sj, name))
            bound = max(1e-9, 100 * _rel(ref, float(getattr(sp, name))))
            assert abs(ref - getattr(st, name).item()) \
                <= bound * abs(ref) + floor[name], (k, name)
        damped = st.guards[tt.Guard.DAMPED].item()
    # The incremental products too (the quadratic and the sphere end at
    # their exact minimum, where the products with g are rounding residue).
    if cfg_kw["direction"] == "compact_incremental" \
            and problem in ("rosenbrock", "coupled_quadratic"):
        for name in ("SY", "YY", "Sg", "Yg"):
            a, b = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-9 * np.abs(b).max(),
                                       err_msg=name)
    if case.startswith("damping") and problem == "rosenbrock":
        assert damped > 0       # the blend ran


@pytest.mark.parametrize("direction", ["two_loop", "compact",
                                       "compact_incremental"])
@pytest.mark.parametrize("with_matvec", [False, True])
def test_bf16_history_f64_iterates_match_jax(direction, with_matvec):
    """A bfloat16 ring under float64 iterates, each direction, fused tail
    with and without its history products: every sum is float64 on both
    sides and a product of two bfloat16 values is exact, so the packages can
    only part where a row value rounds to another bfloat16, which a last-bit
    difference does with probability 2^-45 per element.  Equal alpha and
    counters over 25 iterations of chained Rosenbrock; f and g_norm to
    1e-7 (the one-ulp twin is no yardstick here: its rows round apart)."""
    cfg_kw = dict(line_search="backtracking", direction=direction, m=5,
                  use_pallas=True, ls_eval="polynomial",
                  history_dtype="bfloat16", damping=0.2)
    vg_j, step_j, step_t = _steppers("rosenbrock", cfg_kw,
                                     dict(with_matvec=with_matvec))
    x0 = _x0("rosenbrock", 293, seed=8)
    sj = tl.init_state(vg_j, jnp.asarray(x0), 5, "bfloat16")
    assert sj.s_hist.dtype == jnp.bfloat16
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    assert st.s_hist.dtype == torch.bfloat16 and st.SY.dtype == torch.float64
    for k in range(25):
        sj, st = step_j(sj), step_t(st)
        assert st.alpha.item() == float(sj.alpha), k
        assert st.n_pairs.item() == int(sj.n_pairs), k
        assert st.guards.tolist() == np.asarray(sj.guards).tolist(), k
        np.testing.assert_allclose(st.f.item(), float(sj.f), rtol=1e-7)
        np.testing.assert_allclose(st.g_norm.item(), float(sj.g_norm),
                                   rtol=1e-7)
    # The ring itself: the same bfloat16 values, row for row.
    back = interop.state_to_numpy(st)
    for name in ("s_hist", "y_hist"):
        ref = np.asarray(getattr(sj, name).astype(jnp.float32))
        assert back[name].dtype == np.float32
        assert (back[name] != ref).mean() < 1e-3, name


@pytest.mark.parametrize("direction", ["two_loop", "compact",
                                       "compact_incremental"])
def test_bf16_history_solves_under_each_direction(direction):
    """``LBFGSConfig(history_dtype="bfloat16")`` through the public
    minimize, float32 iterates, fused tail and plain route: it solves, the
    ring is bfloat16, and f tracks the JAX package's within 3e-3 over 8
    iterations (the reference's own bound for a bfloat16 trajectory,
    tests/test_tail_fused.py::test_solver_trajectory_matches_unfused)."""
    d, iters = 1152, 8
    cfg_kw = dict(line_search="backtracking", direction=direction, m=5,
                  ls_eval="polynomial", history_dtype="bfloat16",
                  max_iters=iters, tol=0.0)
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    x0 = _x0("rosenbrock", d, seed=9).astype(np.float32)
    rj = tl.minimize(pj.f, jnp.asarray(x0), tl.LBFGSConfig(**cfg_kw),
                     grad=pj.grad, dir_poly=pj.dir_poly)
    for fused in (False, True):
        extra = dict(value_and_grad=tt.fused_value_and_grad("rosenbrock"),
                     fused_tail=tt.fused_tail_for(
                         "rosenbrock", with_matvec=True, m=5, d=d,
                         history_dtype="bfloat16")) if fused \
            else dict(grad=pt.grad)
        rt = tt.minimize(pt.f, torch.from_numpy(x0),
                         tt.LBFGSConfig(**cfg_kw, use_pallas=fused),
                         dir_poly=pt.dir_poly, **extra)
        assert rt.iterations.item() == int(rj.iterations) == iters
        assert rt.n_fev.item() == int(rj.n_fev)
        np.testing.assert_allclose(rt.f.item(), float(rj.f), rtol=3e-3)
    state = tt.init_state(tt.make_value_and_grad(pt.f, pt.grad),
                          torch.from_numpy(x0), 5, "bfloat16")
    assert state.s_hist.dtype == torch.bfloat16
    assert state.sy_hist.dtype == state.SY.dtype == torch.float32


def test_f32_history_under_f64_iterates_matches_jax():
    """history_dtype="float32" on float64 iterates (it used to raise): the
    ring is float32, everything else float64; 20 iterations without a fused
    tail, equal alpha, f to 1e-7."""
    cfg_kw = dict(line_search="backtracking", direction="compact", m=5,
                  ls_eval="polynomial", history_dtype="float32")
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    cfg_j, cfg_t = tl.LBFGSConfig(**cfg_kw), tt.LBFGSConfig(**cfg_kw)
    x0 = _x0("rosenbrock", 293, seed=10)
    sj = tl.init_state(pj.value_and_grad, jnp.asarray(x0), 5, "float32")
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    assert st.s_hist.dtype == torch.float32 and st.x.dtype == torch.float64
    step = jax.jit(lambda s: tl.iterate(cfg_j, pj.f, pj.value_and_grad, s,
                                        pj.dir_poly))
    vg = tt.make_value_and_grad(pt.f, pt.grad)
    for k in range(20):
        sj, st = step(sj), tt.iterate(cfg_t, pt.f, vg, st, pt.dir_poly)
        assert st.alpha.item() == float(sj.alpha), k
        np.testing.assert_allclose(st.f.item(), float(sj.f), rtol=1e-7)
    assert st.s_hist.dtype == torch.float32


@pytest.mark.parametrize("problem", BODIES)
def test_f32_fused_steps_match_pallas_interpret(problem):
    """float32 iterations against the JAX package's Pallas vg and fused
    tail (with its in-kernel history products) in interpret mode, d = 1152:
    equal alpha, pairs and guards; f within 1e-4 relative, the bound of
    tests/test_torch_solver.py::test_f32_steps_match_pallas_interpret, plus
    1e-9 of the starting f (the coupled quadratic falls by twelve orders of
    magnitude in four iterations, to float32 residue)."""
    cfg_kw = dict(line_search="backtracking",
                  direction="compact_incremental", m=5, use_pallas=True,
                  ls_eval="polynomial")
    vg_j, step_j, step_t = _steppers(problem, cfg_kw,
                                     dict(with_matvec=True))
    x0 = _x0(problem, 1152, seed=11).astype(np.float32)
    sj = tl.init_state(vg_j, jnp.asarray(x0), 5)
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    assert st.x.dtype == torch.float32
    atol = 1e-9 * float(sj.f)
    for k in range({"rosenbrock": 10, "coupled_quadratic": 4,
                    "quadratic": 1}[problem]):
        sj, st = step_j(sj), step_t(st)
        assert st.alpha.item() == float(sj.alpha), k
        np.testing.assert_allclose(st.f.item(), float(sj.f), rtol=1e-4,
                                   atol=atol)
        assert st.n_pairs.item() == int(sj.n_pairs)
        assert st.guards.tolist() == np.asarray(sj.guards).tolist()


def test_plain_tail_under_accurate_dots_is_rejected():
    """cfg.accurate_dots with a tail built without accurate_dots raises the
    reference's ValueError instead of dropping the compensation."""
    cfg_kw = dict(direction="compact_incremental", ls_eval="polynomial",
                  accurate_dots=True, max_iters=2)
    x0 = np.full(64, -1.2)
    for pkg, x in ((tl, jnp.asarray(x0)), (tt, torch.from_numpy(x0))):
        p = pkg.get_problem("rosenbrock")
        with pytest.raises(ValueError, match="accurate_dots=True"):
            pkg.minimize(p.f, x, pkg.LBFGSConfig(**cfg_kw), grad=p.grad,
                         dir_poly=p.dir_poly,
                         fused_tail=pkg.fused_tail_for("rosenbrock"))
    p = tt.get_problem("rosenbrock")
    r = tt.minimize(p.f, torch.from_numpy(x0), tt.LBFGSConfig(**cfg_kw),
                    grad=p.grad, dir_poly=p.dir_poly,
                    fused_tail=tt.fused_tail_for("rosenbrock",
                                                 accurate_dots=True))
    assert r.iterations.item() == 2


@pytest.mark.parametrize("hdtype", ["float32", "bfloat16"])
def test_interop_carries_a_bf16_ring(hdtype):
    """A bfloat16 ring crosses as float32 values that bfloat16 represents
    exactly: JAX state -> port -> arrays -> JAX is the identity, and the
    carrier narrows again to the same ring."""
    pj = tl.get_problem("rosenbrock")
    cfg = tl.LBFGSConfig(direction="compact_incremental", m=4,
                         ls_eval="polynomial", history_dtype=hdtype)
    s = tl.init_state(pj.value_and_grad, jnp.asarray(
        np.random.default_rng(0).uniform(-2, 2, 256), jnp.float32), 4, hdtype)
    for _ in range(6):      # fill and wrap the ring
        s = tl.iterate(cfg, pj.f, pj.value_and_grad, s, pj.dir_poly)
    st = interop.state_from_numpy(_np_state(s), device="cpu")
    assert st.s_hist.dtype == TORCH_DTYPE[hdtype]
    assert st.s_hist.shape == (4, 256) and st.s_hist.abs().sum() > 0
    back = interop.state_to_numpy(st)
    for name in ("s_hist", "y_hist"):
        assert back[name].dtype == np.float32
        restored = jnp.asarray(back[name]).astype(s.s_hist.dtype)
        assert restored.shape == getattr(s, name).shape
        assert bool(jnp.all(restored == getattr(s, name))), name
    again = interop.state_from_numpy(back, history_dtype=hdtype,
                                     device="cpu")
    assert again.s_hist.dtype == st.s_hist.dtype
    assert torch.equal(again.s_hist, st.s_hist)
    assert torch.equal(again.y_hist, st.y_hist)
