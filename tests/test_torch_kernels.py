"""The port's kernel modules against the JAX package, on the CPU.

On the CPU the port's kernel wrappers run their plain PyTorch versions, and
the JAX package's Pallas kernels run in interpret mode (tests/conftest.py
forces the cpu backend), so these tests hold the plain versions to the
Pallas kernels' semantics.  The CUDA kernels themselves are held to the
plain versions on the GPU by chip_smoke.py.  Inputs come from numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lbfgs.kernels import combine_direction as jax_combine
from tpu_lbfgs.kernels import iteration_tail as jax_iteration_tail
from tpu_lbfgs.kernels.pallas_ops import (
    _combine_pallas,
    _fused_tail_pallas,
    _hist3,
    _iteration_tail_pallas,
)
from tpu_lbfgs.kernels.pallas_ops import fused_vg_rosenbrock as jax_vg
from tpu_lbfgs.problems import get_problem as jax_problem
from tpu_lbfgs_torch import kernels
from tpu_lbfgs_torch.kernels.fused_ops import (
    combine_direction,
    combine_direction_matmul,
    combine_direction_plain,
    fused_tail_plain,
    fused_tail_rosenbrock,
    fused_vg_rosenbrock,
    iteration_tail,
    iteration_tail_plain,
    rosenbrock_vg_plain,
)
from tpu_lbfgs_torch.problems import get_problem

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

# Pallas (interpret mode) against the plain version, both float32: the two
# sum in different orders, so the tolerances are those of the reference's
# own Pallas-vs-jnp test (tests/test_tail_fused.py::test_pallas_matches_jnp).
RTOL_F32, ATOL_F32 = 2e-5, 1e-4

TAIL_NAMES = ["x_new", "f_new", "g_new", "s_row", "y_row",
              "sy", "yy", "gg", "dgn", "ggn", "ygn", "t1", "t2"]


def _inputs(d, m, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, d).astype(np.float32)
    dv = rng.uniform(-1, 1, d).astype(np.float32)
    g = rng.uniform(-1, 1, d).astype(np.float32)
    S = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    Y = rng.uniform(-1, 1, (m, d)).astype(np.float32)
    return x, dv, np.float32(0.37), g, S, Y


@pytest.mark.parametrize("d", [1152, 4096])
def test_fused_vg_matches_pallas(d):
    x = _inputs(d, 1)[0]
    f_ref, g_ref = jax_vg(jnp.asarray(x), use_pallas=True)
    f, g = fused_vg_rosenbrock(torch.from_numpy(x))
    assert f.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(f.item(), float(f_ref), rtol=RTOL_F32,
                               atol=ATOL_F32)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=RTOL_F32,
                               atol=ATOL_F32)


@pytest.mark.parametrize("d", [1152, 4096])
def test_fused_tail_matches_pallas(d):
    x, dv, alpha, g, S, Y = _inputs(d, 4, seed=1)
    ref = _fused_tail_pallas("rosenbrock", jnp.asarray(x), jnp.asarray(dv),
                             jnp.asarray(alpha), jnp.asarray(g),
                             jnp.asarray(S), jnp.asarray(Y),
                             with_matvec=False)
    t = torch.from_numpy
    out = fused_tail_rosenbrock(t(x), t(dv), torch.tensor(alpha), t(g),
                                t(S), t(Y))
    assert len(out) == len(ref) == len(TAIL_NAMES)
    for name, a, b in zip(TAIL_NAMES, out, ref):
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_F32,
                                   atol=ATOL_F32, err_msg=name)


def test_tail_is_the_plain_composition_on_cpu():
    """The CPU wrapper is the plain version: bit-equal to composing the
    plain value-and-gradient by hand."""
    x, dv, alpha, g, S, Y = (torch.from_numpy(np.asarray(v))
                             for v in _inputs(515, 3, seed=2))
    out = fused_tail_rosenbrock(x, dv, alpha, g, S, Y)
    ref = fused_tail_plain(rosenbrock_vg_plain, x, dv, alpha, g)
    for name, a, b in zip(TAIL_NAMES, out, ref):
        if b is None:
            assert a is None
            continue
        assert torch.equal(a, b), name


ITER_TAIL_NAMES = ["x_new", "s", "y", "sy", "yy", "gg", "dgn", "ggn"]


def _tail_inputs(d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, d).astype(dtype) for _ in range(4))


@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("d", [1152, 4096])
def test_iteration_tail_plain_matches_pallas(d, accurate):
    """The plain iteration tail against the interpreted Pallas kernel,
    plain and compensated, float32: the vectors are the same three
    elementwise expressions (equal to an ulp, Pallas on the CPU may fuse
    the multiply-add); the five sums differ by their order and their
    accumulator (float32 blocks there, float64 or compensated chunks
    here), RTOL_F32 / ATOL_F32."""
    x, dv, g, gn = _tail_inputs(d, 5)
    alpha = np.float32(0.37)
    ref = _iteration_tail_pallas(*map(jnp.asarray, (x, dv, alpha, g, gn)),
                                 accurate=accurate)
    t = torch.from_numpy
    for use_pallas in (True, False):
        out = iteration_tail(t(x), t(dv), torch.tensor(alpha), t(g), t(gn),
                             use_pallas=use_pallas, accurate=accurate)
        assert len(out) == len(ref) == len(ITER_TAIL_NAMES)
        for name, a, b in zip(ITER_TAIL_NAMES, out, ref):
            assert a.dtype == torch.float32, name
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=RTOL_F32, atol=ATOL_F32,
                                       err_msg=name)


@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("d", [293, 1000])
def test_iteration_tail_matches_jax_f64(d, accurate):
    """float64, any d (the reference takes its jnp fallback there, with
    compensated_dot when accurate): sums to 1e-13 of sum |terms|."""
    x, dv, g, gn = _tail_inputs(d, 6, np.float64)
    ref = jax_iteration_tail(*map(jnp.asarray, (x, dv, 0.37, g, gn)),
                             use_pallas=True, accurate=accurate)
    t = torch.from_numpy
    out = iteration_tail(t(x), t(dv), torch.tensor(0.37, dtype=torch.float64),
                         t(g), t(gn), accurate=accurate)
    for name, a, b in zip(ITER_TAIL_NAMES, out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-13 * d, err_msg=name)


def test_iteration_tail_on_cpu_is_the_plain_version():
    x, dv, g, gn = map(torch.from_numpy, _tail_inputs(515, 7))
    alpha = torch.tensor(0.25)
    for accurate in (False, True):
        out = iteration_tail(x, dv, alpha, g, gn, accurate=accurate)
        ref = iteration_tail_plain(x, dv, alpha, g, gn, accurate)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    # batched: one step per lane, sums over the last axis
    xb, db, gb, gnb = (v.reshape(5, 103) for v in (x, dv, g, gn))
    ab = torch.linspace(0.1, 0.5, 5)
    out = iteration_tail(xb, db, ab, gb, gnb)
    for lane in range(5):
        ref = iteration_tail_plain(xb[lane], db[lane], ab[lane], gb[lane],
                                   gnb[lane])
        assert all(torch.equal(a[lane], b) for a, b in zip(out, ref))


def test_compensated_tail_tracks_f64_on_lossy_data():
    """tests/test_kernels.py's data, built to lose bits in a float32
    running sum (g_new ~ 1: the sum of squares grows by ~1 per element):
    the compensated plain tail stays within a few float32 rounding units
    of the float64 truth, as the reference's compensated kernel must, and
    is no worse than a float32 dot; the vectors do not depend on the
    flag."""
    d = 1 << 17
    rng = np.random.default_rng(11)
    gn = torch.from_numpy(
        (1.0 + 1e-3 * rng.standard_normal(d)).astype(np.float32))
    g = torch.from_numpy((1e-3 * rng.standard_normal(d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    dv = torch.from_numpy(rng.standard_normal(d).astype(np.float32))
    alpha = torch.tensor(0.37)
    exact = float(gn.double() @ gn.double())
    plain = iteration_tail(x, dv, alpha, g, gn, accurate=False)
    comp = iteration_tail(x, dv, alpha, g, gn, accurate=True)
    err = abs(comp[5].item() - exact)
    assert err < 64.0 * np.finfo(np.float32).eps * exact
    assert err <= abs(torch.dot(gn, gn).item() - exact)
    assert torch.equal(plain[0], comp[0]) and torch.equal(plain[2], comp[2])


def _combine_inputs(d, m, dtype=np.float32):
    rng = np.random.default_rng(m)
    g = rng.normal(size=d).astype(dtype)
    S, Y = (rng.normal(size=(m, d)).astype(dtype) for _ in range(2))
    v, u = (rng.normal(size=m).astype(dtype) for _ in range(2))
    return g, S, Y, v, u, dtype(0.8)


@pytest.mark.parametrize("m", [5, 10])
@pytest.mark.parametrize("d", [1152, 4096])
def test_combine_direction_plain_matches_pallas(d, m):
    """The plain combine runs the Pallas kernel's accumulation order, so
    against the interpreted kernel it differs at most by a fused
    multiply-add's rounding per row: 1e-6 of the largest entry.  The
    matrix-vector route sums in another order: 1e-5 (the reference's own
    kernel-vs-jnp tolerance is 1e-4)."""
    g, S, Y, v, u, gamma = _combine_inputs(d, m)
    ref = np.asarray(_combine_pallas(
        jnp.asarray(g), _hist3(jnp.asarray(S)), _hist3(jnp.asarray(Y)),
        jnp.asarray(v), jnp.asarray(u), jnp.asarray(gamma)))
    args = [torch.from_numpy(np.asarray(a)) for a in (g, S, Y, v, u, gamma)]
    scale = np.abs(ref).max()
    plain = combine_direction_plain(*args)
    assert plain.dtype == torch.float32 and plain.shape == (d,)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=1e-6 * scale)
    assert torch.equal(combine_direction(*args, use_pallas=True), plain)
    routed = combine_direction(*args, use_pallas=False)
    assert torch.equal(routed, combine_direction_matmul(*args))
    np.testing.assert_allclose(routed.numpy(), ref, rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("m", [1, 5, 20])
def test_combine_direction_matches_jax_f64(m):
    """float64 at a d that is no multiple of 128 (the reference takes its
    matmul route there): both of the port's forms to 1e-12."""
    g, S, Y, v, u, gamma = _combine_inputs(300, m, np.float64)
    ref = np.asarray(jax_combine(*map(jnp.asarray, (g, S, Y, v, u, gamma)),
                                 use_pallas=True))
    args = [torch.from_numpy(np.asarray(a)) for a in (g, S, Y, v, u, gamma)]
    for fn in (combine_direction_plain, combine_direction_matmul):
        np.testing.assert_allclose(fn(*args).numpy(), ref, rtol=1e-12,
                                   atol=1e-12)


def test_combine_direction_matmul_takes_a_batch():
    g, S, Y, v, u, gamma = (torch.from_numpy(np.asarray(a))
                            for a in _combine_inputs(64, 5, np.float64))
    B = 3
    gb, Sb, Yb, vb, ub = (torch.stack([a * (i + 1) for i in range(B)])
                          for a in (g, S, Y, v, u))
    gammab = gamma * torch.arange(1, B + 1, dtype=torch.float64)
    out = combine_direction(gb, Sb, Yb, vb, ub, gammab, use_pallas=False)
    for i in range(B):
        np.testing.assert_allclose(
            out[i].numpy(),
            combine_direction_matmul(gb[i], Sb[i], Yb[i], vb[i], ub[i],
                                     gammab[i]).numpy(), rtol=1e-13)
    # use_pallas=True on the CPU: the batched plain version, each lane's
    # row equal to the one-instance call on it bit for bit.
    out = combine_direction(gb, Sb, Yb, vb, ub, gammab, use_pallas=True)
    for i in range(B):
        assert torch.equal(out[i], combine_direction_plain(
            gb[i], Sb[i], Yb[i], vb[i], ub[i], gammab[i]))


def test_general_kernels_refuse_what_they_cannot_take():
    """Off the CPU the two wrappers launch their kernel or raise."""
    x = torch.zeros(16, device="meta")
    a = torch.zeros((), device="meta")
    H = torch.zeros(4, 16, device="meta")
    c = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        iteration_tail(x, x, a, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        combine_direction(x, H, H, c, c, a)
    with pytest.raises(TypeError, match="float32 or float64"):
        combine_direction(x.half(), H, H, c, c, a)
    assert kernels.iteration_tail is iteration_tail
    assert kernels.combine_direction is combine_direction
    assert {"iteration_tail", "combine_direction"} <= set(
        kernels.launch_counts())


@pytest.mark.parametrize("name", ["rosenbrock", "quadratic", "sphere",
                                  "coupled_quadratic"])
def test_problem_suite_matches_jax_f64(name):
    # Same formulas in the same order, float64: only the sums' order
    # differs, so 1e-12 relative is ample.
    rng = np.random.default_rng(3)
    x, dv = rng.uniform(-2, 2, 1000), rng.uniform(-1, 1, 1000)
    pj, pt = jax_problem(name), get_problem(name)
    xt, dt = torch.from_numpy(x), torch.from_numpy(dv)
    np.testing.assert_allclose(pt.f(xt).item(), float(pj.f(jnp.asarray(x))),
                               rtol=1e-12)
    np.testing.assert_allclose(pt.grad(xt).numpy(),
                               np.asarray(pj.grad(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        pt.dir_poly(xt, dt).numpy(),
        np.asarray(pj.dir_poly(jnp.asarray(x), jnp.asarray(dv))),
        rtol=1e-12, atol=1e-9)


def test_vg_plain_is_problem_f_and_grad():
    x = torch.from_numpy(np.random.default_rng(4).uniform(-2, 2, 333))
    p = get_problem("rosenbrock")
    f, g = rosenbrock_vg_plain(x)
    assert torch.equal(f, p.f(x))
    assert torch.equal(g, p.grad(x))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_vg_plain_tiny_chains(n):
    # Edge masking: n=1 has no term; every coordinate still gets a gradient.
    x = np.random.default_rng(n).uniform(-2, 2, n)
    f_ref, g_ref = jax_vg(jnp.asarray(x), use_pallas=False)
    f, g = rosenbrock_vg_plain(torch.from_numpy(x))
    np.testing.assert_allclose(f.item(), float(f_ref), rtol=1e-15)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=1e-15)
