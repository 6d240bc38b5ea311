"""The port's search directions against the JAX package, on the CPU.

States come from the JAX package (its ``iterate`` run for a few steps, so
that the ring is empty, partly filled or wrapped) and cross with
``tpu_lbfgs_torch.interop``; some then get a damaged pair, in both
packages' copies alike.  Both packages compute the direction of the same
state; everything is float64, so the two differ only by the order of their
sums.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.core import direction as jdir
from tpu_lbfgs.types import LBFGSState as JaxState
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.core import direction as tdir

torch.set_num_threads(1)

# float64 on both sides, sums in another order: a direction is a sum of up
# to 2m + 1 vectors with coefficients of both signs, so it is held to 1e-9
# of its largest entry (observed below 1e-12).
DIR_RTOL = 1e-9
D = 256
# Iterations before the state is taken: empty, partial and wrapped rings.
FILL = {"empty": 0, "partial": 4, "wrapped": 23}


def _jax_state(m, fill, seed=0, d=D):
    """The JAX package's state after ``fill`` iterations of its default
    solve (two_loop, backtracking) on chained Rosenbrock, incremental
    products kept up to date so that every direction can read it."""
    p = tl.get_problem("rosenbrock")
    cfg = tl.LBFGSConfig(m=m, direction="compact_incremental")
    x0 = -1.2 + np.random.default_rng(seed).uniform(-0.1, 0.1, d)
    s = tl.init_state(p.value_and_grad, jnp.asarray(x0), m)
    step = jax.jit(lambda t: tl.iterate(cfg, p.f, p.value_and_grad, t))
    for _ in range(fill):
        s = step(s)
    return {k: np.array(v) for k, v in s._asdict().items()}


def _both(arrays):
    sj = JaxState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return sj, interop.state_from_numpy(arrays, device="cpu")


def _damage(arrays, how, m):
    """Damage the newest or an older stored pair's s.y in place (or y.y,
    or an unfilled slot's s.y on a partial ring)."""
    n = int(arrays["n_pairs"])
    newest, older = (n - 1) % m, (n - 2) % m
    if how == "zero_sy":            # rho = inf on an older pair
        arrays["sy_hist"][older] = 0.0
    elif how == "nan_sy":
        arrays["sy_hist"][older] = np.nan
    elif how == "inf_sy":
        arrays["sy_hist"][older] = np.inf
    elif how == "nan_sy_invalid":   # a slot no pair has filled yet
        assert n < m
        arrays["sy_hist"][n % m] = np.nan
    elif how == "nan_yy":
        arrays["yy_hist"][older] = np.nan
    elif how == "tiny_sy":          # below the pair-skip threshold
        arrays["sy_hist"][older] = 1e-14
    elif how == "negative_gamma":
        arrays["sy_hist"][newest] = -1.0
    return arrays


def _assert_direction(dt, dj):
    dj = np.asarray(dj)
    scale = np.max(np.abs(dj))
    np.testing.assert_allclose(dt.numpy(), dj, rtol=0, atol=DIR_RTOL * scale)


@pytest.mark.parametrize("direction", ["two_loop", "compact",
                                       "compact_incremental"])
@pytest.mark.parametrize("skip", [None, 1e-10])
@pytest.mark.parametrize("fill", sorted(FILL))
@pytest.mark.parametrize("m", [5, 10])
def test_direction_matches_jax(m, fill, skip, direction):
    """d, the fallback flag and, for the compact forms, the coefficients
    and phi'(0), for every ring fill, both guard modes and m = 5, 10."""
    sj, st = _both(_jax_state(m, FILL[fill]))
    cj = tl.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    ct = tt.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    dj, auxj, fbj = jdir.compute_direction_with_aux(cj, sj)
    dt, auxt, fbt = tdir.compute_direction_with_aux(ct, st)
    assert bool(fbt) == bool(fbj) == (fill == "empty")
    _assert_direction(dt, dj)
    assert torch.equal(tdir.compute_direction(ct, st), dt)
    if direction == "two_loop":
        assert auxt is None and auxj is None
        return
    for name in ("gamma", "v_phys", "u_phys", "g_dot_d"):
        np.testing.assert_allclose(getattr(auxt, name).numpy(),
                                   np.asarray(getattr(auxj, name)),
                                   rtol=1e-8, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("direction", ["two_loop", "compact"])
@pytest.mark.parametrize("skip", [None, 1e-10])
@pytest.mark.parametrize("how", ["zero_sy", "nan_sy", "tiny_sy",
                                 "negative_gamma", "inf_sy",
                                 "nan_sy_invalid", "nan_yy"])
def test_damaged_pairs_take_the_reference_guards(how, skip, direction):
    """A non-finite rho falls back to -g without the pair skip and skips
    the pair with it; a non-positive gamma always falls back; a pair below
    the threshold is skipped.  Flag and direction equal the reference's
    compiled direction (its solvers run it under jit) in every case.

    The compact chain's one-hot matmuls (tpu_lbfgs/kernels/chain.py:67-80)
    spread a non-finite product to every entry of SY, YY, Sg, Yg, and the
    port spreads it the same way (``kernels.chain.onehot_spread``): a NaN
    s.y under the pair skip then masks every pair, where the port's index
    gathers used to mask that pair only.  gamma's one-hot sums
    (tpu_lbfgs/core/direction.py:79-97) compile to selects and spread
    nothing, as the port's gather; the two-loop reads s.y by a gather in
    both packages."""
    m = 5
    fill = FILL["partial" if how == "nan_sy_invalid" else "wrapped"]
    arrays = _damage(_jax_state(m, fill), how, m)
    n = int(arrays["n_pairs"])
    slot = n % m if how == "nan_sy_invalid" else (n - 2) % m
    if direction == "compact":
        # compact reads s.y and y.y from its own contraction: damage those
        # too.
        sj0, _ = _both(arrays)
        SY, YY = (np.array(a) for a in jdir.history_products(sj0)[:2])
    sj, st = _both(arrays)
    cj = tl.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    ct = tt.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    if direction == "two_loop":
        dj, fbj = jax.jit(lambda s: jdir._two_loop_core(cj, s))(sj)
        dt, fbt = tdir._two_loop_core(ct, st)
        expect = (how == "negative_gamma"
                  or (skip is None and how in ("zero_sy", "nan_sy")))
        assert bool(fbt) == expect
    else:
        SY[slot, slot] = arrays["sy_hist"][slot]
        YY[slot, slot] = arrays["yy_hist"][slot]
        Sg, Yg = (np.array(a) for a in jdir.history_products(sj)[2:])
        dj, _, fbj = jax.jit(lambda s, *p: jdir._compact_core(cj, s, *p))(
            sj, *map(jnp.asarray, (SY, YY, Sg, Yg)))
        dt, _, fbt = tdir._compact_core(ct, st, *map(torch.from_numpy,
                                                     (SY, YY, Sg, Yg)))
    assert bool(fbt) == bool(fbj)
    if bool(fbj):
        assert torch.equal(dt, -st.g)
    _assert_direction(dt, dj)
    assert tdir.two_loop_direction(ct, st).shape == (D,)


@pytest.mark.parametrize("m", [5, 10])
def test_history_products_match_jax(m):
    sj, st = _both(_jax_state(m, FILL["wrapped"]))
    for name, a, b in zip(("SY", "YY", "Sg", "Yg"),
                          tdir.history_products(st),
                          jdir.history_products(sj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12,
                                   atol=1e-12, err_msg=name)


def test_two_loop_equals_compact():
    """The two formulations are the same matrix: on one state they give
    the same direction to rounding (the reference's own cross-check)."""
    _, st = _both(_jax_state(10, FILL["wrapped"]))
    cfg = tt.LBFGSConfig()
    a = tdir.two_loop_direction(cfg, st)
    b = tdir.compact_direction(cfg, st)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                               atol=1e-8 * a.abs().max().item())


@pytest.mark.parametrize("direction", ["two_loop", "compact"])
@pytest.mark.parametrize("skip", [None, 1e-10])
def test_batched_direction_matches_vmap(direction, skip):
    """A batch of states with different fills (each lane its own ring
    position) against ``jax.vmap`` of the reference's direction."""
    m = 5
    lanes = [_jax_state(m, fill, seed=i)
             for i, fill in enumerate((0, 3, 7, 12))]
    lanes[3] = _damage(lanes[3], "zero_sy", m)
    arrays = {k: np.stack([lane[k] for lane in lanes]) for k in lanes[0]}
    sj, st = _both(arrays)
    assert st.s_hist.shape == (4, m, D)
    cj = tl.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    ct = tt.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    dj, _, fbj = jax.vmap(
        lambda s: jdir.compute_direction_with_aux(cj, s))(sj)
    dt, _, fbt = tdir.compute_direction_with_aux(ct, st)
    np.testing.assert_array_equal(fbt.numpy(), np.asarray(fbj))
    for lane in range(4):
        _assert_direction(dt[lane], dj[lane])


@pytest.mark.parametrize("direction", ["two_loop", "compact"])
@pytest.mark.parametrize("skip", [None, 1e-10])
def test_batched_damaged_lanes_match_jax(direction, skip):
    """The damaged states of ``test_damaged_pairs_take_the_reference_guards``
    as lanes of one batch (a NaN and an inf s.y, a NaN y.y, a NaN in an
    unfilled slot, one lane undamaged), with the compact direction's
    products damaged alike, against ``jax.jit(jax.vmap(...))`` of the
    reference's direction: equal fallback flags and directions."""
    m = 5
    hows = ["nan_sy", "inf_sy", "nan_yy", "nan_sy_invalid", None]
    lanes = [_damage(_jax_state(m, FILL["partial" if how == "nan_sy_invalid"
                                       else "wrapped"]), how, m)
             if how else _jax_state(m, FILL["wrapped"]) for how in hows]
    arrays = {k: np.stack([lane[k] for lane in lanes]) for k in lanes[0]}
    sj, st = _both(arrays)
    prods = None
    if direction == "compact":
        prods = [np.array(a) for a in jax.vmap(jdir.history_products)(sj)]
        for i, how in enumerate(hows):
            if how is None:
                continue
            n = int(arrays["n_pairs"][i])
            slot = n % m if how == "nan_sy_invalid" else (n - 2) % m
            prods[0][i, slot, slot] = arrays["sy_hist"][i, slot]
            prods[1][i, slot, slot] = arrays["yy_hist"][i, slot]
    cj = tl.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    ct = tt.LBFGSConfig(m=m, direction=direction, pair_skip_threshold=skip)
    if direction == "two_loop":
        dj, fbj = jax.jit(jax.vmap(lambda s: jdir._two_loop_core(cj, s)))(sj)
        dt, fbt = tdir._two_loop_core(ct, st)
    else:
        dj, _, fbj = jax.jit(jax.vmap(
            lambda s, *p: jdir._compact_core(cj, s, *p)))(
                sj, *map(jnp.asarray, prods))
        dt, _, fbt = tdir._compact_core(ct, st, *map(torch.from_numpy,
                                                     prods))
    np.testing.assert_array_equal(fbt.numpy(), np.asarray(fbj))
    assert not bool(fbt[-1])
    for lane in range(len(hows)):
        _assert_direction(dt[lane], dj[lane])


def test_direction_reads_nothing_on_the_host(monkeypatch):
    """The two-loop's 2m passes are selects: no Tensor.item / bool / index
    with a 0-d tensor, which would wait for the device on the card."""
    _, st = _both(_jax_state(5, FILL["wrapped"]))

    def refuse(self):
        raise AssertionError("host read inside the direction")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    monkeypatch.setattr(torch.Tensor, "__index__", refuse)
    for direction in ("two_loop", "compact", "compact_incremental"):
        tdir.compute_direction_with_aux(
            tt.LBFGSConfig(m=5, direction=direction), st)
