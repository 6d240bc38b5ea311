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

from tpu_lbfgs.kernels.pallas_ops import _fused_tail_pallas
from tpu_lbfgs.kernels.pallas_ops import fused_vg_rosenbrock as jax_vg
from tpu_lbfgs.problems import get_problem as jax_problem
from tpu_lbfgs_torch.kernels.fused_ops import (
    fused_tail_plain,
    fused_tail_rosenbrock,
    fused_vg_rosenbrock,
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


@pytest.mark.parametrize("name", ["rosenbrock", "quadratic", "sphere"])
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
