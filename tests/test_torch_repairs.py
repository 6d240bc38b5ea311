"""Two differences from the reference that could change an iterate,
repaired and held to the JAX package on the CPU.

- Damping's ``1 - mu`` rounds in the working dtype: mu is a fill in that
  dtype, as the reference's ``jnp.asarray(cfg.damping, sy.dtype)``
  (``tpu_lbfgs/core/solver.py:318-322``), not a Python float, whose
  ``1.0 - mu`` rounds from a double.  In float32 the two differ for mu =
  0.33 (0.67 against 0.66999996) and 0.8.
- The batched compact chain's non-finite rule asks about the whole batch
  under ``sharded_vmap_minimize``: the reference's ``custom_vmap`` rule
  sees the global vmapped axis (``tpu_lbfgs/kernels/chain.py:313-325``),
  where a row of the port's mesh holds B / b lanes.

The ranks of the second test import this module, so it imports JAX and the
JAX package only inside the tests.
"""
import contextlib

import numpy as np
import pytest
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.dist.launch import spawn_ranks

torch.set_num_threads(1)


def _quadratic(pkg, c):
    """0.5 c x^2 summed, its gradient and its directional polynomial, in
    ``pkg``'s arrays (np for the JAX package's jnp)."""
    xp = pkg

    def f(x):
        return 0.5 * xp.sum(c * x * x)

    def grad(x):
        return c * x

    def dir_poly(x, d):
        return xp.stack([0.5 * xp.sum(c * x * x), xp.sum(c * x * d),
                         0.5 * xp.sum(c * d * d)])

    return f, grad, dir_poly


@pytest.mark.parametrize("mu", [0.33, 0.8])
@pytest.mark.parametrize("x", [1.0, 3.0, 0.7])
@pytest.mark.parametrize("c", [0.0625, 0.1, 0.3])
def test_damping_theta_rounds_in_float32_as_the_reference(c, x, mu):
    """One float32 iteration of a one-dimensional quadratic with curvature
    c < mu, where Powell damping fires at the first pair: every sum is one
    product, so both packages form s.y, s.s and gamma alike, and theta =
    (1 - mu) s'Bs / (s'Bs - s.y) sets the stored pair.  The stored row and
    its s.y, y.y equal the JAX package's bit for bit, run op by op (its
    jitted CPU code contracts and reorders the blend); a Python-float mu
    misses on 12 of these 18 cases."""
    import jax
    import jax.numpy as jnp

    import tpu_lbfgs as tl

    kw = dict(line_search="backtracking", direction="two_loop",
              ls_eval="polynomial", damping=mu, m=4, tol=0.0)
    fj, gj, pj = _quadratic(jnp, np.float32(c))
    ft, gt, pt = _quadratic(torch, np.float32(c))
    vgj = tl.make_value_and_grad(fj, gj)
    vgt = tt.make_value_and_grad(ft, gt)
    with jax.disable_jit():
        sj = tl.iterate(tl.LBFGSConfig(**kw), fj, vgj,
                        tl.init_state(vgj, jnp.asarray([x], jnp.float32), 4),
                        pj)
    st = tt.iterate(tt.LBFGSConfig(**kw), ft, vgt,
                    tt.init_state(vgt, torch.tensor([x], dtype=torch.float32),
                                  4), pt)
    want = interop.state_from_numpy(
        {k: np.asarray(v) for k, v in sj._asdict().items()}, device="cpu")
    assert want.guards[tt.Guard.DAMPED].item() == 1
    for name in ("x", "f", "s_hist", "y_hist", "sy_hist", "yy_hist",
                 "guards"):
        assert torch.equal(getattr(st, name), getattr(want, name)), name


# --- the batched chain's rule under sharded_vmap_minimize -------------------

B, D, M = 1024, 8, 3
DAMAGED = (0, 5, 600, 1000)
CHAIN_CFG = dict(line_search="backtracking", direction="compact_incremental",
                 ls_eval="polynomial", m=M, tol=0.0, max_iters=3)


def _chain_rule_rank(rank, size, arrays, repaired):
    """Rank ``rank`` of a 2 x 1 (b, d) mesh: one iteration of its row's
    lanes of the damaged batch through ``dist.solve_shard_from_state``;
    with ``repaired`` False the rule is asked about the row's lanes, as
    before the repair.  Returns the lanes' x and guard counters."""
    from tpu_lbfgs_torch import dist as tdist
    from tpu_lbfgs_torch.dist import sharded

    mesh = tdist.make_mesh_2d(batch_size=2)
    lanes = B // size
    mine = {k: v[rank * lanes:(rank + 1) * lanes] for k, v in arrays.items()}
    state = interop.state_from_numpy(mine, device="cpu")
    cfg = tt.LBFGSConfig(**CHAIN_CFG)
    rule = sharded.whole_batch
    if not repaired:
        sharded.whole_batch = lambda size: contextlib.nullcontext()
    try:
        res, _ = tdist.solve_shard_from_state(state, D, cfg, mesh,
                                              problem="rosenbrock")
    finally:
        sharded.whole_batch = rule
    return res.x.numpy(), res.guards.numpy()


def test_sharded_batch_asks_the_chain_about_the_whole_batch():
    """A float32 batch of B = 1024 on a 2 x 1 mesh, 512 lanes a row, after
    two iterations, with a NaN in the unfilled slot of SY on four lanes:
    the reference's vmapped iterate takes its select-based Pallas chain
    (float32, 1024 % 1024 == 0), which never reads that slot, so no lane
    falls back.  Asked about a row's 512 lanes, the port spread the NaN as
    the one-hot matmuls do and fell back to -g on the four lanes (x far
    from the reference's); asked about the whole batch it takes every
    lane's direction as the reference does: no fallback, x to float32
    rounding (the port adds in float64)."""
    import jax
    import jax.numpy as jnp

    import tpu_lbfgs as tl

    cfg = tl.LBFGSConfig(**CHAIN_CFG)
    p = tl.get_problem("rosenbrock")
    vg = tl.make_value_and_grad(p.f, p.grad)
    x0 = np.random.default_rng(0).uniform(-2, 2, (B, D)).astype(np.float32)
    step = jax.jit(jax.vmap(lambda s: tl.iterate(cfg, p.f, vg, s,
                                                 p.dir_poly)))
    s = jax.jit(jax.vmap(lambda x: tl.init_state(vg, x, M)))(jnp.asarray(x0))
    s = step(step(s))
    arrays = {k: np.array(v) for k, v in s._asdict().items()}
    assert (arrays["n_pairs"][list(DAMAGED)] == 2).all()
    for b in DAMAGED:
        arrays["SY"][b, 2, 2] = np.nan
    ref = step(jax.tree.map(jnp.asarray, tl.LBFGSState(**arrays)))
    ref_x, ref_fb = np.asarray(ref.x), np.asarray(ref.guards)[:, 0]
    assert not ref_fb.any()

    runs = {}
    for repaired in (False, True):
        outs = spawn_ranks(_chain_rule_rank, 2, arrays, repaired,
                           backend="gloo")
        runs[repaired] = (np.concatenate([o[0] for o in outs]),
                          np.concatenate([o[1] for o in outs])[:, 0])
    x, fb = runs[False]
    assert fb[list(DAMAGED)].all() and fb.sum() == len(DAMAGED)
    assert np.abs(x - ref_x)[list(DAMAGED)].max() > 0.1
    x, fb = runs[True]
    np.testing.assert_array_equal(fb, ref_fb)
    np.testing.assert_allclose(x, ref_x, rtol=1e-5, atol=1e-5)
