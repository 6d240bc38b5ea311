"""The batched forms of the port's kernel wrappers against the JAX package's
kernels under ``jax.vmap``, on the CPU.

The reference gets a batch by ``jax.vmap`` over a ``pallas_call``; the
port's wrappers take a leading lane axis of (B, d) rows and launch the
kernels' batched forms on the card.  On the CPU a wrapper runs its plain
version, and the JAX package's Pallas kernels run in interpret mode
(tests/conftest.py forces the cpu backend), so these tests hold each
batched plain version to the vmapped kernel: iteration_tail (float32
through Pallas, float64 through the jnp route), the value and gradient of
the three bodies, the fused tail of the three bodies with and without the
history products, on a float32 and a bfloat16 ring, plain and
compensated, and the combine on both rings.  Every batched plain version
also equals its one-instance plain version row by row, bit for bit: the
card's check (chip_smoke.py ``[batch-kernels]``) holds the batched kernels
to the batched plain versions and rests on that.  The one exception is a
float64 sum, which the one-instance version takes from ``torch.dot`` (BLAS
on the CPU) and the batched one from a reduction over the last axis: no
batched reduction adds in BLAS's order, so those two agree to 1e-13 of
sum|terms| (the float64 tolerance of tests/test_torch_kernels.py), where
a float32 sum, formed in float64 and rounded once, is bit-equal.

Inputs come from numpy.  One step per lane, lane 0's step 0 (a failed
search: x_new = x, s = 0) and, where B > 2, lane 1 frozen (d = 0 and
g_new = g: nothing moves, every sum but g.g is 0).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lbfgs.kernels import iteration_tail as jax_iteration_tail
from tpu_lbfgs.kernels.pallas_ops import FUSED_VG as JAX_FUSED_VG
from tpu_lbfgs.kernels.pallas_ops import (
    _combine_pallas,
    _fused_tail_pallas,
    _hist3,
    _iteration_tail_pallas,
)
from tpu_lbfgs_torch.kernels import fused_ops

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

BODIES = ["quadratic", "rosenbrock", "coupled_quadratic"]
# Pallas (interpret mode) against the plain version, both float32: the
# tolerances of the one-instance tests (tests/test_torch_kernels.py,
# tests/test_torch_suite_kernels.py), those of the reference's own
# Pallas-vs-jnp test.
RTOL_F32, ATOL_F32 = 2e-5, 1e-4
TAIL_NAMES = ["x_new", "f_new", "g_new", "s_row", "y_row",
              "sy", "yy", "gg", "dgn", "ggn", "ygn", "t1", "t2"]
ITER_TAIL_NAMES = ["x_new", "s", "y", "sy", "yy", "gg", "dgn", "ggn"]
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _lanes(B, d, seed, dtype=np.float32):
    """x ~ U(-2, 2), d, g, g_new ~ U(-1, 1) as (B, d) rows and one step per
    lane; lane 0's step is 0 and, for B > 2, lane 1 is frozen."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (B, d)).astype(dtype)
    dv, g, gn = (rng.uniform(-1, 1, (B, d)).astype(dtype) for _ in range(3))
    alpha = (2.0 ** rng.uniform(-3, 1, B)).astype(dtype)
    alpha[0] = 0.0
    if B > 2:
        dv[1] = 0.0
        gn[1] = g[1]
    return x, dv, alpha, g, gn


def _ring(B, m, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.uniform(-1, 1, (B, m, d)).astype(np.float32)
                 for _ in range(2))


def _f32(a):
    """A JAX or torch array (bfloat16 included) as float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _rows_equal(batched, one, B, d=None):
    """Each output of a batched call equals the one-instance call on its
    row, bit for bit (None where the one-instance output is None); a
    float64 sum within 1e-13 (relative and times d absolute, ``d`` given)."""
    for i in range(B):
        single = one(i)
        for a, b in zip(batched, single):
            if b is None:
                assert a is None
                continue
            if b.dim() == 0 and b.dtype == torch.float64:
                np.testing.assert_allclose(a[i].item(), b.item(),
                                           rtol=1e-13, atol=1e-13 * d)
                continue
            assert torch.equal(a[i], b), i


t = torch.from_numpy


# --- iteration_tail ---------------------------------------------------------

@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("d", [128, 256])
def test_iteration_tail_matches_vmapped_pallas(d, B, accurate):
    """float32, d a multiple of 128 (the reference's Pallas rule):
    ``iteration_tail(use_pallas=True)`` on (B, d) rows against
    ``jax.vmap`` of the interpreted Pallas kernel, RTOL_F32 / ATOL_F32 on
    every output, sums (B,)."""
    x, dv, alpha, g, gn = _lanes(B, d, seed=d + B)
    ref = jax.vmap(lambda *a: _iteration_tail_pallas(*a, accurate=accurate))(
        *map(jnp.asarray, (x, dv, alpha, g, gn)))
    out = fused_ops.iteration_tail(t(x), t(dv), t(alpha), t(g), t(gn),
                                   accurate=accurate)
    assert len(out) == len(ref) == len(ITER_TAIL_NAMES)
    for name, a, b in zip(ITER_TAIL_NAMES, out, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_F32,
                                   atol=ATOL_F32, err_msg=name)
    # Lane 0 took no step: x_new is x and s is 0.
    assert torch.equal(out[0][0], t(x)[0]) and not out[1][0].any()
    _rows_equal(out, lambda i: fused_ops.iteration_tail_plain(
        t(x)[i], t(dv)[i], t(alpha)[i], t(g)[i], t(gn)[i], accurate), B)


@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("d", [293, 1000])
def test_iteration_tail_matches_vmapped_jax_f64(d, accurate):
    """float64 (the reference takes its jnp route there, with
    compensated_dot when accurate) at B = 5: sums to 1e-13 of
    sum |terms|, as tests/test_torch_kernels.py holds one instance."""
    B = 5
    x, dv, alpha, g, gn = _lanes(B, d, seed=d, dtype=np.float64)
    ref = jax.vmap(lambda *a: jax_iteration_tail(
        *a, use_pallas=True, accurate=accurate))(
        *map(jnp.asarray, (x, dv, alpha, g, gn)))
    out = fused_ops.iteration_tail(t(x), t(dv), t(alpha), t(g), t(gn),
                                   accurate=accurate)
    for name, a, b in zip(ITER_TAIL_NAMES, out, ref):
        assert a.dtype == torch.float64 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=1e-13 * d, err_msg=name)
    _rows_equal(out, lambda i: fused_ops.iteration_tail_plain(
        t(x)[i], t(dv)[i], t(alpha)[i], t(g)[i], t(gn)[i], accurate), B, d)


# --- value and gradient -----------------------------------------------------

@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("problem", BODIES)
def test_fused_vg_matches_vmapped_pallas(problem, B):
    """Each body's value and gradient on (B, d) rows against ``jax.vmap`` of
    the interpreted Pallas kernel: f (B,), no neighbour term across a lane
    boundary (every lane's first element has no backward neighbour and its
    last no forward one, as the reference's vmapped kernel has them)."""
    d = 1152
    x = _lanes(B, d, seed=7)[0]
    f_ref, g_ref = jax.vmap(lambda v: JAX_FUSED_VG[problem](
        v, use_pallas=True))(jnp.asarray(x))
    f, g = fused_ops.FUSED_VG[problem](t(x))
    assert f.shape == (B,) and g.shape == (B, d)
    assert f.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), rtol=RTOL_F32,
                               atol=ATOL_F32)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_ref), rtol=RTOL_F32,
                               atol=ATOL_F32)
    _rows_equal((f, g), lambda i: fused_ops.VG_PLAIN[problem](t(x)[i]), B)


# --- the fused tail ---------------------------------------------------------

@pytest.mark.parametrize("accurate", [False, True])
@pytest.mark.parametrize("hdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [0, 5, 10])
@pytest.mark.parametrize("problem", BODIES)
def test_fused_tail_matches_vmapped_pallas(problem, m, hdtype, accurate):
    """``make_fused_tail`` on B = 3 lanes of d = 1152 (no multiple of the
    Pallas block), with the history products at m = 5 and 10 or without
    them, float32 and bfloat16 ring, plain and compensated, against
    ``jax.vmap`` of the interpreted Pallas tail: RTOL_F32 / ATOL_F32 on
    every output, the rows compared as float32.  t1 and t2, (B, m), are
    sums of products that cancel, which the Pallas kernel adds in float32:
    they are held to RTOL_F32 of each product's sum|terms| (plus
    ATOL_F32), and to the exact float64 products of the widened ring
    within 1e-6 of it, as tests/test_torch_suite_kernels.py::
    test_fused_tail_matvec_at_m10 holds one instance."""
    B, d = 3, 1152
    x, dv, alpha, g, _ = _lanes(B, d, seed=11)
    S, Y = _ring(B, max(m, 1), d, seed=12)
    Sj, Yj = (jnp.asarray(a).astype(hdtype) for a in (S, Y))
    ref = jax.vmap(lambda *a: _fused_tail_pallas(
        problem, *a, m > 0, accurate=accurate))(
        jnp.asarray(x), jnp.asarray(dv), jnp.asarray(alpha), jnp.asarray(g),
        Sj, Yj)
    St, Yt = (t(a).to(TORCH_DTYPE[hdtype]) for a in (S, Y))
    tail = fused_ops.make_fused_tail(problem, fused_ops.VG_PLAIN[problem],
                                     with_matvec=m > 0,
                                     accurate_dots=accurate)
    out = tail(t(x), t(dv), t(alpha), t(g), St, Yt)
    assert len(out) == len(ref) == len(TAIL_NAMES)
    for name, a, b in zip(TAIL_NAMES, out, ref):
        if b is None:
            assert a is None and m == 0, name
            continue
        want = TORCH_DTYPE[hdtype] if name in ("s_row", "y_row") \
            else torch.float32
        assert a.dtype == want and tuple(a.shape) == b.shape, name
        if name in ("t1", "t2"):
            hist = (St if name == "t1" else Yt).double()
            y = (out[2] - t(g)).double().unsqueeze(-1)   # the raw float32 y
            scale = torch.bmm(hist.abs(), y.abs()).squeeze(-1).numpy()
            exact = torch.bmm(hist, y).squeeze(-1).numpy()
            assert (np.abs(_f32(a) - _f32(b))
                    <= RTOL_F32 * scale + ATOL_F32).all(), name
            assert (np.abs(a.double().numpy() - exact) <= 1e-6 * scale).all()
            continue
        np.testing.assert_allclose(_f32(a), _f32(b), rtol=RTOL_F32,
                                   atol=ATOL_F32, err_msg=name)
    _rows_equal(out, lambda i: fused_ops.fused_tail_plain(
        fused_ops.VG_PLAIN[problem], t(x)[i], t(dv)[i], t(alpha)[i],
        t(g)[i], St[i], Yt[i], m > 0, accurate), B)


# --- combine_direction ------------------------------------------------------

@pytest.mark.parametrize("hdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [5, 10])
def test_combine_direction_matches_vmapped_pallas(m, hdtype):
    """The combine on B = 4 lanes of d = 1152 with a (B, m, d) ring, (B, m)
    coefficients and (B,) gamma, against ``jax.vmap`` of the interpreted
    Pallas kernel: the same accumulation order, so within one fused
    multiply-add's rounding per row, 1e-6 of the largest entry, as the
    one-instance test holds it.  A bfloat16 ring is widened as it is read,
    in both."""
    B, d = 4, 1152
    rng = np.random.default_rng(m)
    g = rng.normal(size=(B, d)).astype(np.float32)
    S, Y = (rng.normal(size=(B, m, d)).astype(np.float32) for _ in range(2))
    v, u = (rng.normal(size=(B, m)).astype(np.float32) for _ in range(2))
    gamma = rng.uniform(0.5, 1.5, B).astype(np.float32)
    Sj, Yj = (jnp.asarray(a).astype(hdtype) for a in (S, Y))
    ref = np.asarray(jax.vmap(lambda g_, s_, y_, v_, u_, c_: _combine_pallas(
        g_, _hist3(s_), _hist3(y_), v_, u_, c_))(
        jnp.asarray(g), Sj, Yj, jnp.asarray(v), jnp.asarray(u),
        jnp.asarray(gamma)))
    St, Yt = (t(a).to(TORCH_DTYPE[hdtype]) for a in (S, Y))
    args = (t(g), St, Yt, t(v), t(u), t(gamma))
    out = fused_ops.combine_direction(*args)
    assert out.dtype == torch.float32 and out.shape == (B, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-6 * np.abs(ref).max())
    assert torch.equal(out, fused_ops.combine_direction_plain(*args))
    _rows_equal((out,), lambda i: (fused_ops.combine_direction_plain(
        *(a[i] for a in args)),), B)


@pytest.mark.parametrize("m", [1, 7])
def test_combine_direction_batch_f64_rows(m):
    """float64 with a ring in the iterate's dtype: the batched plain
    combine equals the one-instance plain combine on each row bit for bit,
    and the matrix-vector route to 1e-12."""
    B, d = 3, 300
    rng = np.random.default_rng(m + 1)
    g = rng.normal(size=(B, d))
    S, Y = (rng.normal(size=(B, m, d)) for _ in range(2))
    v, u = (rng.normal(size=(B, m)) for _ in range(2))
    gamma = rng.uniform(0.5, 1.5, B)
    args = tuple(map(t, (g, S, Y, v, u, gamma)))
    out = fused_ops.combine_direction(*args)
    _rows_equal((out,), lambda i: (fused_ops.combine_direction_plain(
        *(a[i] for a in args)),), B)
    np.testing.assert_allclose(
        out.numpy(), fused_ops.combine_direction_matmul(*args).numpy(),
        rtol=1e-12, atol=1e-12)


# --- what a batched wrapper refuses off the CPU ------------------------------

def test_batched_wrappers_refuse_other_devices():
    """Off the CPU a batched call launches its kernel or raises: a meta
    tensor stands in for a CUDA one and is refused before any launch; a
    rank the kernels do not take is refused too, and nothing is counted."""
    fused_ops.reset_launches()
    x = torch.zeros(3, 16, device="meta")
    a = torch.zeros(3, device="meta")
    H = torch.zeros(3, 4, 16, device="meta")
    c = torch.zeros(3, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.iteration_tail(x, x, a, x, x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.fused_vg("rosenbrock", x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.make_fused_tail("rosenbrock", None)(x, x, a, x, H, H)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.combine_direction(x, H, H, c, c, a)
    assert not any(fused_ops.launches.values())
    assert {f"{b}_{k}_batched" for b in BODIES for k in ("vg", "fused_tail")}
    assert {"iteration_tail_batched", "combine_direction_batched"} <= set(
        fused_ops.launches)
