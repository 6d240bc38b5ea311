"""The port's solve against the JAX package, step for step, on the CPU.

Both solvers start from one state: the JAX package's init_state, carried
over with tpu_lbfgs_torch.interop.  Then each takes the same iterations
with bench.py's configuration (chained Rosenbrock, compact_incremental
direction, Armijo backtracking on the directional polynomial, m=10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.bench.harness import _x0 as jax_x0
from tpu_lbfgs.core.solver import _polyval as jax_polyval
from tpu_lbfgs.linesearch.strategies import backtracking as jax_backtracking
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.bench.harness import _x0 as torch_x0
from tpu_lbfgs_torch.core.solver import _polyval
from tpu_lbfgs_torch.linesearch.strategies import backtracking

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

BENCH = dict(line_search="backtracking", direction="compact_incremental",
             m=10, use_pallas=True, ls_eval="polynomial")


def _np_state(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _jax_stepper(cfg):
    p = tl.get_problem("rosenbrock")
    vg = tl.fused_value_and_grad("rosenbrock", use_pallas=True)
    tail = tl.fused_tail_for("rosenbrock", with_matvec=False, use_pallas=True)
    return vg, jax.jit(lambda s: tl.iterate(cfg, p.f, vg, s, p.dir_poly, tail))


def _torch_step(cfg, state):
    p = tt.get_problem("rosenbrock")
    return tt.iterate(cfg, p.f, tt.fused_value_and_grad("rosenbrock"), state,
                      p.dir_poly, tt.fused_tail_for("rosenbrock"))


def _rel(a, b):
    return abs(a - b) / abs(a)


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_f64_trajectory_matches_jax(seed, fidelity):
    """100 float64 iterations at d=1024: equal alpha, status, n_pairs and
    guard counters at every iteration; f and g_norm as close as rounding
    allows.

    How close that is: L-BFGS on chained Rosenbrock amplifies a rounding
    difference by roughly 1.4x per iteration, so no implementation that sums
    in another order than XLA can hold 1e-9 for 100 iterations.  The test
    measures the amplification on the JAX package itself, by a second JAX
    run from x0 with every seventh coordinate moved by one ulp, and holds
    the port to 1e-9 or 100x that run's own deviation, whichever is larger.
    (Observed: the port deviates 1x-15x as much as the one-ulp run.)  The
    start is the classic Rosenbrock point -1.2, jittered: from U(-2, 2) the
    amplification flips an Armijo decision of the JAX package against
    itself within 85-110 iterations."""
    d, iters = 1024, 100
    cfg_j = tl.LBFGSConfig(**BENCH, fidelity=fidelity)
    cfg_t = tt.LBFGSConfig(**BENCH, fidelity=fidelity)
    vg, step = _jax_stepper(cfg_j)
    x0 = -1.2 + np.random.default_rng(seed).uniform(-0.1, 0.1, d)
    x1 = x0.copy()
    x1[::7] = np.nextafter(x1[::7], np.inf)
    sj = tl.init_state(vg, jnp.asarray(x0), cfg_j.m)
    sp = tl.init_state(vg, jnp.asarray(x1), cfg_j.m)
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    for k in range(iters):
        sj, sp, st = step(sj), step(sp), _torch_step(cfg_t, st)
        assert st.alpha.item() == float(sj.alpha), k
        assert st.status.item() == int(sj.status), k
        assert st.n_pairs.item() == int(sj.n_pairs), k
        assert st.guards.tolist() == np.asarray(sj.guards).tolist(), k
        for name in ("f", "g_norm"):
            ref = float(getattr(sj, name))
            bound = max(1e-9, 100 * _rel(ref, float(getattr(sp, name))))
            assert _rel(ref, getattr(st, name).item()) <= bound, (k, name)
    assert st.k.item() == iters


@pytest.mark.parametrize("d", [1152, 4096])
def test_f32_steps_match_pallas_interpret(d):
    """10 float32 iterations against the JAX package's Pallas vg and fused
    tail in interpret mode: equal alpha; f within 1e-4 relative (the sums'
    order differs, and f32 rounding grows along the trajectory; observed
    below 3e-5)."""
    cfg_j, cfg_t = tl.LBFGSConfig(**BENCH), tt.LBFGSConfig(**BENCH)
    vg, step = _jax_stepper(cfg_j)
    sj = tl.init_state(vg, jax_x0(d, 0, jnp.float32), cfg_j.m)
    st = interop.state_from_numpy(_np_state(sj), device="cpu")
    assert st.x.dtype == torch.float32
    for k in range(10):
        sj, st = step(sj), _torch_step(cfg_t, st)
        assert st.alpha.item() == float(sj.alpha), k
        np.testing.assert_allclose(st.f.item(), float(sj.f), rtol=1e-4)
        assert st.n_pairs.item() == int(sj.n_pairs)
        assert st.guards.tolist() == np.asarray(sj.guards).tolist()


def test_minimize_matches_jax_end_to_end():
    """bench.py's solve at d=2048: 50 float32 iterations at tol=0 through
    both packages' public minimize.  Counters and status must agree; f
    within 2e-3 relative, the float32 form of the amplification described
    in test_f64_trajectory_matches_jax (observed 3e-5 at seed 42, up to
    1e-3 at other seeds).  g_norm is not compared: it moves far more than f
    between nearby iterates on this trajectory.  Nor is the pair-reject
    counter: it counts s.y <= 0 decisions on near-zero float32 sums, which
    the JAX package accumulates in float32 and the port in float64 (at
    seed 42 JAX rejects two pairs that the port keeps)."""
    d, iters = 2048, 50
    pj, pt = tl.get_problem("rosenbrock"), tt.get_problem("rosenbrock")
    rj = tl.minimize(
        pj.f, jax_x0(d, 42, jnp.float32),
        tl.LBFGSConfig(**BENCH, max_iters=iters, tol=0.0),
        value_and_grad=tl.fused_value_and_grad("rosenbrock", use_pallas=True),
        dir_poly=pj.dir_poly,
        fused_tail=tl.fused_tail_for("rosenbrock", with_matvec=False,
                                     use_pallas=True))
    rt = tt.minimize(
        pt.f, torch_x0(d, 42, torch.float32),
        tt.LBFGSConfig(**BENCH, max_iters=iters, tol=0.0),
        value_and_grad=tt.fused_value_and_grad("rosenbrock"),
        dir_poly=pt.dir_poly, fused_tail=tt.fused_tail_for("rosenbrock"))
    assert rt.iterations.item() == int(rj.iterations) == iters
    assert rt.status.item() == int(rj.status) == tt.Status.MAX_ITERS
    assert rt.n_fev.item() == int(rj.n_fev)
    assert rt.n_gev.item() == int(rj.n_gev)
    keep = [i for i in range(tt.Guard.N) if i != tt.Guard.PAIR_REJECT]
    assert rt.guards[keep].tolist() == np.asarray(rj.guards)[keep].tolist()
    assert rt.x.shape == (d,) and torch.isfinite(rt.x).all()
    np.testing.assert_allclose(rt.f.item(), float(rj.f), rtol=2e-3)


@pytest.mark.parametrize("fidelity,rescue", [("reference", None),
                                             ("fixed", None),
                                             ("reference", 1e-4),
                                             ("fixed", 1e-4)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_backtracking_ladder_matches_loop(fidelity, rescue, dtype):
    """The port tests the whole ladder at once; the reference loops.  On
    the same polynomials both must return the same alpha bit for bit,
    including searches that accept nothing and the rescue."""
    cfg_j = tl.LBFGSConfig(fidelity=fidelity, alpha_rescue_floor=rescue)
    cfg_t = tt.LBFGSConfig(fidelity=fidelity, alpha_rescue_floor=rescue)
    search_j = jax.jit(lambda c, gd: jax_backtracking(
        cfg_j, lambda a: jax_polyval(c, a), None, c[0], gd))
    rng = np.random.default_rng(5)
    seen_broke = seen_accept = 0
    for trial in range(40):
        coeffs = (rng.normal(size=5)
                  * 10.0 ** rng.integers(-3, 4, size=5)).astype(dtype)
        if trial % 4 == 0:
            coeffs[1] = abs(coeffs[1])     # ascent: nothing is accepted
        gd = -abs(coeffs[1]) if trial % 4 else abs(coeffs[1])
        ref = search_j(jnp.asarray(coeffs), jnp.asarray(gd, coeffs.dtype))
        ct = torch.from_numpy(coeffs)
        out = backtracking(cfg_t, lambda a: _polyval(ct, a), None, ct[0],
                           torch.tensor(gd, dtype=ct.dtype))
        assert out.alpha.item() == float(ref.alpha), trial
        assert out.alpha.dtype == ct.dtype
        assert out.n_fev.item() == int(ref.n_fev), trial
        assert out.rescued.item() == int(ref.rescued), trial
        seen_broke += int(ref.n_fev) == 27
        seen_accept += int(ref.n_fev) < 27
    assert seen_broke and seen_accept
