"""The port's line searches, interpolation helpers and K-trial kernels
against the JAX package, on the CPU.

The searches see the objective only through phi / phi_dphi, so each case
hands both packages the same one-dimensional problem: the Rosenbrock cases
of tests/test_linesearch.py (dim 16, float64, direct evaluation) and the
random polynomials of tests/test_speculative_ls.py and
tests/test_speculative_wolfe.py.  The port runs each search eagerly.  The
K-trial kernels' plain
versions (the port's wrappers on CPU tensors) are held to the JAX
package's Pallas kernels in interpret mode.
"""
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.core.solver import make_phi as jax_make_phi
from tpu_lbfgs.kernels.pallas_ops import (
    _multi_phi_dphi_pallas,
    _multi_phi_pallas,
)
from tpu_lbfgs.linesearch import interpolate as jax_interp
from tpu_lbfgs.linesearch import strategies as jax_ls
from tpu_lbfgs_torch.core.solver import make_phi
from tpu_lbfgs_torch.kernels import line_search_ops as ops
from tpu_lbfgs_torch.kernels.fused_ops import (
    rosenbrock_f_plain,
    rosenbrock_vg_plain,
)
from tpu_lbfgs_torch.linesearch import interpolate as interp
from tpu_lbfgs_torch.linesearch import strategies as ls

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

STRATEGIES = list(tt.config.LINE_SEARCH_METHODS)
TWINS = {"backtracking_speculative": "backtracking",
         "wolfe_interpolation_speculative": "wolfe_interpolation",
         "backtracking_wolfe_speculative": "backtracking_wolfe"}

# Alpha on the Rosenbrock cases: both packages evaluate f and g . d in
# float64 with their sums in different orders, so alpha may move in the
# last bits of an interpolated step (the tolerance of
# tests/test_linesearch.py::test_alpha_parity).
ALPHA_RTOL, ALPHA_ATOL = 1e-9, 1e-12


def _rosenbrock_np(x):
    t = x[1:] - x[:-1] ** 2
    f = np.sum(100.0 * t * t + (1.0 - x[:-1]) ** 2)
    g = np.zeros_like(x)
    g[:-1] = 2.0 * (x[:-1] - 1.0) - 400.0 * x[:-1] * t
    g[1:] += 200.0 * t
    return f, g


def _cases(seed=0, n=12, dim=16):
    """tests/test_linesearch.py::_cases: random points on Rosenbrock with
    descent directions of varying quality."""
    rng = np.random.default_rng(seed)
    cases = []
    for i in range(n):
        x = rng.uniform(-2, 2, dim)
        fx, g = _rosenbrock_np(x)
        if i % 3 == 0:
            d = -g
        elif i % 3 == 1:
            d = -g + 0.1 * rng.normal(size=dim) * np.linalg.norm(g)
        else:
            d = -g * rng.uniform(0.001, 5.0)
        if float(np.dot(g, d)) >= 0:
            d = -g
        cases.append((x, d))
    return cases


def _jax_search_on_rosenbrock(cfg):
    p = tl.get_problem("rosenbrock")

    def run(x, d):
        phi, phi_dphi = jax_make_phi(cfg, p.f, p.value_and_grad, x, d)
        fx, gx = p.value_and_grad(x)
        return jax_ls.get_line_search(cfg.line_search)(
            cfg, phi, phi_dphi, fx, jnp.vdot(gx, d))

    return jax.jit(run)


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_alpha_parity_rosenbrock_cases(strategy, fidelity):
    kw = dict(line_search=strategy, fidelity=fidelity, c2=0.9)
    cfg_j, cfg_t = tl.LBFGSConfig(**kw), tt.LBFGSConfig(**kw)
    run_j = _jax_search_on_rosenbrock(cfg_j)
    p = tt.get_problem("rosenbrock")
    for i, (x, d) in enumerate(_cases()):
        ref = run_j(jnp.asarray(x), jnp.asarray(d))
        xt, dt = torch.from_numpy(x), torch.from_numpy(d)
        phi, phi_dphi = make_phi(cfg_t, p.f, p.value_and_grad, xt, dt)
        fx, gx = p.value_and_grad(xt)
        out = ls.get_line_search(strategy)(cfg_t, phi, phi_dphi, fx,
                                           torch.dot(gx, dt))
        np.testing.assert_allclose(out.alpha.item(), float(ref.alpha),
                                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL,
                                   err_msg=f"case {i}")
        assert out.alpha.dtype == torch.float64
        assert out.n_fev.item() == int(ref.n_fev), i
        assert out.n_gev.item() == int(ref.n_gev), i
        assert out.rescued.item() == int(ref.rescued), i


# --- random polynomials: alpha bit for bit -----------------------------------

def _jax_poly(coeffs):
    d = coeffs[1:] * jnp.arange(1, coeffs.shape[0], dtype=coeffs.dtype)

    def horner(c, a):
        acc = c[-1] * jnp.ones_like(a)
        for k in range(c.shape[0] - 2, -1, -1):
            acc = acc * a + c[k]
        return acc

    return (lambda a: horner(coeffs, a),
            lambda a: (horner(coeffs, a), horner(d, a)))


def _torch_poly(coeffs):
    d = coeffs[1:] * torch.arange(1, coeffs.shape[0], dtype=coeffs.dtype)

    def horner(c, a):
        acc = c[-1] * torch.ones_like(a)
        for k in range(c.shape[0] - 2, -1, -1):
            acc = acc * a + c[k]
        return acc

    return (lambda a: horner(coeffs, a),
            lambda a: (horner(coeffs, a), horner(d, a)))


def _random_cubics(n=40):
    """tests/test_speculative_ls.py: phi(a) = f_x + g.d a + q a^2 + c a^3
    with g.d < 0, float32."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        g_dot_d = -np.abs(rng.normal()) - 1e-3
        f_x, q, c = rng.normal(), rng.normal() * 10, rng.normal()
        out.append(np.array([f_x, g_dot_d, q, c], np.float32))
    return out


# tests/test_speculative_wolfe.py::POLYS, float64: accept at 1, long doubling
# ladders, zoom entries, growth.
POLYS = [np.array(c, np.float64) for c in (
    [1.0, -1.0, 0.5], [1.0, -1.0, 0.005], [1.0, -1.0, 0.0005],
    [1.0, -2.0, 0.02], [5.0, -4.0, 2.0, -0.5, 0.03], [1.0, -0.1, 2.0],
    [1.0, -0.01, 8.0])]


# The searches whose alpha is an interpolated value.
INTERPOLATING = ("armijo_interpolation", "wolfe_interpolation",
                 "wolfe_interpolation_speculative")


def _poly_searches(strategy, fidelity, **kw):
    """The JAX search is jitted once, except an interpolating search, which
    runs op by op (jax.disable_jit): jitted, XLA's CPU backend fuses a
    multiply and an add into one fused multiply-add where it sees fit, and
    that moves an interpolated alpha by an ulp (tests/test_torch_direct.py
    meets it too).  Op by op, every operation rounds once, as in the port
    and in its CUDA kernels (-fmad=false).  The other searches' alphas are
    products of exact ladders, which a contraction cannot move."""
    cfg_kw = dict(line_search=strategy, fidelity=fidelity, c2=0.9, **kw)
    cfg_j, cfg_t = tl.LBFGSConfig(**cfg_kw), tt.LBFGSConfig(**cfg_kw)

    def search_j(coeffs):
        phi, phi_dphi = _jax_poly(coeffs)
        return jax_ls.get_line_search(strategy)(cfg_j, phi, phi_dphi,
                                                coeffs[0], coeffs[1])

    def run_j(coeffs):
        with jax.disable_jit():
            return search_j(coeffs)

    def run_t(coeffs):
        phi, phi_dphi = _torch_poly(coeffs)
        return ls.get_line_search(strategy)(cfg_t, phi, phi_dphi, coeffs[0],
                                            coeffs[1])

    return (run_j if strategy in INTERPOLATING else jax.jit(search_j)), run_t


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_alpha_bit_equal_on_random_polynomials(strategy, fidelity):
    """Every search, both fidelity modes, on the float32 cubics and the
    float64 polynomials: the same alpha bit for bit, and the same counts."""
    run_j, run_t = _poly_searches(strategy, fidelity)
    for i, coeffs in enumerate(_random_cubics() + POLYS):
        ref = run_j(jnp.asarray(coeffs))
        out = run_t(torch.from_numpy(coeffs))
        assert out.alpha.dtype == torch.from_numpy(coeffs).dtype
        assert out.alpha.item() == float(ref.alpha), (i, coeffs)
        assert out.n_fev.item() == int(ref.n_fev), i
        assert out.n_gev.item() == int(ref.n_gev), i
        assert out.rescued.item() == int(ref.rescued), i


@pytest.mark.parametrize("spec_width", [4, 8])
@pytest.mark.parametrize("twin", sorted(TWINS))
@pytest.mark.parametrize("shrink", [0.5, 0.7])
def test_twin_alpha_equals_sequential(twin, spec_width, shrink):
    """In the port, each speculative twin takes its sequential search's
    alpha bit for bit (for a shrink that is no power of two the Wolfe tree
    delegates), on the polynomials and on the Rosenbrock cases."""
    cfg = tt.LBFGSConfig(line_search=twin, c2=0.9, spec_width=spec_width,
                         shrink=shrink)
    spec, seq = ls.get_line_search(twin), ls.get_line_search(TWINS[twin])
    for coeffs in _random_cubics() + POLYS:
        c = torch.from_numpy(coeffs)
        phi, phi_dphi = _torch_poly(c)
        a_spec = spec(cfg, phi, phi_dphi, c[0], c[1]).alpha.item()
        assert a_spec == seq(cfg, phi, phi_dphi, c[0], c[1]).alpha.item()
    p = tt.get_problem("rosenbrock")
    for x, d in _cases(seed=1):
        xt, dt = torch.from_numpy(x), torch.from_numpy(d)
        phi, phi_dphi = make_phi(cfg, p.f, p.value_and_grad, xt, dt)
        fx, gx = p.value_and_grad(xt)
        gd = torch.dot(gx, dt)
        a_spec = spec(cfg, phi, phi_dphi, fx, gd).alpha.item()
        assert a_spec == seq(cfg, phi, phi_dphi, fx, gd).alpha.item()


def test_search_reads_one_flag_per_turn():
    """The sequential search reads its loop condition once per trial; the
    speculative twin once per round of K = 8 trials.  phi(a) = 1 - a +
    0.0005 a^2 with c2 = 0.1 accepts a = 1024 after doubling from 1: 11
    trials, or two rounds."""
    phi, phi_dphi = _torch_poly(torch.tensor([1.0, -1.0, 0.0005],
                                             dtype=torch.float64))
    f_x, gd = torch.tensor(1.0, dtype=torch.float64), torch.tensor(
        -1.0, dtype=torch.float64)
    for name, trials, reads in (("wolfe_interpolation", 11, 11),
                                ("wolfe_interpolation_speculative", 16, 2)):
        cfg = tt.LBFGSConfig(line_search=name, c2=0.1)
        ls.reset_host_reads()
        out = ls.get_line_search(name)(cfg, phi, phi_dphi, f_x, gd)
        assert out.alpha.item() == 1024.0
        assert out.n_fev.item() == trials
        assert ls.host_reads["line_search"] == reads, name


# --- the interpolation helpers -----------------------------------------------

def _interp_inputs(n=4000, seed=7):
    """Random brackets, with negative discriminants, equal endpoints,
    -0.0 spans, NaN and infinite slopes mixed in."""
    rng = np.random.default_rng(seed)
    a0, a1 = rng.uniform(-2, 3, n), rng.uniform(-2, 3, n)
    p0, p1 = rng.normal(size=n) * 10, rng.normal(size=n) * 10
    dp0, dp1 = rng.normal(size=n) * 10, rng.normal(size=n) * 10
    a1[::17] = a0[::17]                       # zero-width interval
    a0[5::23], a1[5::23] = 0.0, -0.0          # a -0.0 span
    dp0[3::29] = np.nan
    dp1[7::31] = np.inf
    p1[11::37] = -np.inf
    return a0, a1, p0, dp0, p1, dp1


@pytest.mark.parametrize("name,fixed", [
    ("cubic_interpolate", None), ("cubic_interpolate_fixed", None),
    ("safe_cubic_interpolate", False), ("safe_cubic_interpolate", True),
    ("quadratic_interpolate", None), ("quadratic_interpolate_fixed", None)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_interpolation_matches_jax(name, fixed, dtype):
    args = [a.astype(dtype) for a in _interp_inputs()]
    if name == "quadratic_interpolate":
        args = args[:5]
    elif name == "quadratic_interpolate_fixed":
        args = args[:4]
    kw = {} if fixed is None else {"fixed": fixed}
    with np.errstate(all="ignore"):
        ref = np.asarray(getattr(jax_interp, name)(
            *map(jnp.asarray, args), **kw))
    out = getattr(interp, name)(*map(torch.from_numpy, args), **kw).numpy()
    assert out.dtype == ref.dtype == dtype
    np.testing.assert_array_equal(out, ref)
    if name == "cubic_interpolate":
        assert np.isnan(ref).sum() > 100     # negative discriminants
    if name == "safe_cubic_interpolate":
        assert not np.isnan(ref[~np.isnan(args[0] + args[1])]).any()


def test_copysign_keeps_the_reference_form():
    """+|a| for b = -0.0, where torch.copysign would give -|a|."""
    a = torch.tensor([2.0, 2.0, -2.0, 2.0])
    b = torch.tensor([-0.0, 0.0, 1.0, -1.0])
    assert interp._copysign(a, b).tolist() == [2.0, 2.0, 2.0, -2.0]
    ref = jax_interp._copysign(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    assert np.asarray(ref).tolist() == [2.0, 2.0, 2.0, -2.0]


# --- kernels 5 and 6: plain versions against the Pallas kernels --------------

def _kernel_inputs(n, k, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, n).astype(np.float32)
    d = rng.uniform(-1, 1, n).astype(np.float32)
    alphas = (2.0 ** rng.integers(-6, 3, k)
              * rng.uniform(0.5, 1.0, k)).astype(np.float32)
    return x, d, alphas


def _abs_terms(x, d, alphas):
    """Per trial, sum |f terms| and sum |g_i d_i| in float64: the bound of
    a sum's rounding scales with them, not with the cancelled total."""
    f_abs, g_abs = [], []
    for a in alphas.astype(np.float64):
        u = x + a * d
        _, g = _rosenbrock_np(u)
        t = u[1:] - u[:-1] ** 2
        f_abs.append(np.sum(np.abs(100.0 * t * t + (1.0 - u[:-1]) ** 2)))
        g_abs.append(np.sum(np.abs(g * d)))
    return np.array(f_abs), np.array(g_abs)


# The plain versions against the interpreted Pallas kernels, float32: the
# Pallas kernels add float32 terms in float32, the plain versions in float64,
# in other orders; both are held to 1e-5 of the sum of |terms|.
SUM_RTOL = 1e-5


@pytest.mark.parametrize("k", [8, 36])
def test_multi_phi_plain_matches_pallas(k):
    x, d, alphas = _kernel_inputs(2048, k)
    ref = np.asarray(_multi_phi_pallas("rosenbrock", jnp.asarray(x),
                                       jnp.asarray(d), jnp.asarray(alphas)))
    t = torch.from_numpy
    out = ops.multi_phi_rosenbrock(t(x), t(d), t(alphas))
    assert out.shape == (k,) and out.dtype == torch.float32
    f_abs, _ = _abs_terms(x.astype(np.float64), d.astype(np.float64), alphas)
    assert np.all(np.abs(out.numpy() - ref) <= SUM_RTOL * f_abs)
    assert torch.equal(out, ops.multi_phi_plain(rosenbrock_f_plain, t(x),
                                                t(d), t(alphas)))


@pytest.mark.parametrize("k", [8, 36])
def test_multi_phi_dphi_plain_matches_pallas(k):
    x, d, alphas = _kernel_inputs(2048, k, seed=4)
    ref_f, ref_g = (np.asarray(v) for v in _multi_phi_dphi_pallas(
        "rosenbrock", jnp.asarray(x), jnp.asarray(d), jnp.asarray(alphas)))
    t = torch.from_numpy
    phi, dphi = ops.multi_phi_dphi_rosenbrock(t(x), t(d), t(alphas))
    assert phi.shape == dphi.shape == (k,)
    assert phi.dtype == dphi.dtype == torch.float32
    f_abs, g_abs = _abs_terms(x.astype(np.float64), d.astype(np.float64),
                              alphas)
    assert np.all(np.abs(phi.numpy() - ref_f) <= SUM_RTOL * f_abs)
    assert np.all(np.abs(dphi.numpy() - ref_g) <= SUM_RTOL * g_abs)
    p_phi, p_dphi = ops.multi_phi_dphi_plain(rosenbrock_vg_plain, t(x), t(d),
                                             t(alphas))
    assert torch.equal(phi, p_phi) and torch.equal(dphi, p_dphi)


@pytest.mark.parametrize("n", [1, 2, 3, 37])
def test_plain_batches_equal_single_trials(n):
    """Row k of a K-trial plain evaluation is the single trial at alpha_k,
    down to chains with no term."""
    x, d, alphas = (torch.from_numpy(v).double()
                    for v in _kernel_inputs(n, 5, seed=n))
    phis = ops.multi_phi_plain(rosenbrock_f_plain, x, d, alphas)
    fs, dphis = ops.multi_phi_dphi_plain(rosenbrock_vg_plain, x, d, alphas)
    for k, a in enumerate(alphas.unbind(0)):
        f_k, g_k = rosenbrock_vg_plain(x + a * d)
        assert phis[k] == fs[k]
        # One sum over K rows against K sums: the orders may differ.
        torch.testing.assert_close(phis[k], f_k, rtol=1e-14, atol=0)
        torch.testing.assert_close(dphis[k], torch.dot(g_k, d), rtol=1e-13,
                                   atol=1e-13)


def test_suite_hands_out_kernels_and_plain_versions():
    # With use_pallas=True the suite hands out the kernel wrappers, built
    # per call from the problem's name: off the CPU they launch or raise,
    # on the CPU they equal the module's own Rosenbrock evaluators.
    meta = torch.zeros(16, device="meta")
    x, d, alphas = (torch.from_numpy(v) for v in _kernel_inputs(64, 3))
    for make, own in ((tt.multi_phi_for, ops.multi_phi_rosenbrock),
                      (tt.multi_phi_dphi_for, ops.multi_phi_dphi_rosenbrock)):
        with pytest.raises(ValueError, match="CUDA"):
            make("rosenbrock")(meta, meta, torch.zeros(4, device="meta"))
        got, want = make("rosenbrock")(x, d, alphas), own(x, d, alphas)
        assert all(torch.equal(a, b) for a, b in zip(
            got if isinstance(got, tuple) else (got,),
            want if isinstance(want, tuple) else (want,)))
    x, d, alphas = (torch.from_numpy(v).double()
                    for v in _kernel_inputs(64, 3))
    for name in ("rosenbrock", "quadratic", "sphere"):
        p = tt.get_problem(name)
        fs = tt.multi_phi_for(name, use_pallas=False)(x, d, alphas)
        phis, dphis = tt.multi_phi_dphi_for(name, use_pallas=False)(x, d,
                                                                    alphas)
        for k, a in enumerate(alphas.unbind(0)):
            torch.testing.assert_close(fs[k], p.f(x + a * d), rtol=1e-13,
                                       atol=0)
            torch.testing.assert_close(phis[k], fs[k], rtol=1e-13, atol=0)
            torch.testing.assert_close(
                dphis[k], torch.dot(p.grad(x + a * d), d), rtol=1e-12,
                atol=1e-12)


def test_kernel_wrappers_refuse_other_devices():
    x = torch.zeros(16, device="meta")
    a = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ops.multi_phi_rosenbrock(x, x, a)
    with pytest.raises(ValueError, match="CUDA"):
        ops.multi_phi_dphi_rosenbrock(x, x, a)


# --- the speculative-selection rule ------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_resolve_speculative_auto_matches_jax(strategy):
    """The same decision as the JAX package's rule on probe results on both
    sides of the threshold; the port's probe carries 0-d tensors."""
    assert ls.SPECULATIVE_TRIALS_THRESHOLD == \
        jax_ls.SPECULATIVE_TRIALS_THRESHOLD
    assert ls.SPECULATIVE_TWINS == jax_ls.SPECULATIVE_TWINS
    cfg_j = tl.LBFGSConfig(line_search=strategy)
    cfg_t = tt.LBFGSConfig(line_search=strategy)
    thr = ls.SPECULATIVE_TRIALS_THRESHOLD
    for iters, trials in ((50, 1.5), (50, thr - 0.02), (50, thr),
                          (50, 12.0), (0, 3.0), (7, 20.0)):
        n_fev = int(math.floor(max(iters, 1) * (1 + trials)))
        ref = jax_ls.resolve_speculative_auto(
            cfg_j, SimpleNamespace(iterations=iters, n_fev=n_fev))
        out = ls.resolve_speculative_auto(cfg_t, SimpleNamespace(
            iterations=torch.tensor(iters, dtype=torch.int32),
            n_fev=torch.tensor(n_fev, dtype=torch.int32)))
        assert out.line_search == ref.line_search, (iters, trials)
        assert out == cfg_t.replace(line_search=ref.line_search)
