"""Every line search over a batch of lanes, and its two loops, on the CPU.

The searches see the objective only through phi / phi_dphi, so each lane
here is a one-dimensional polynomial: the float32 cubics of
tests/test_speculative_ls.py and the float64 polynomials of
tests/test_speculative_wolfe.py (the cases of tests/test_torch_linesearch.py),
one row of coefficients per lane, evaluated through the port's
``core.solver.make_phi`` (its lane rule: a step of the lanes' shape is one
trial per lane, one more trailing axis is K trials per lane).

- Per lane, the port's batched search equals the JAX package's search on
  that lane: alpha bit for bit, n_fev, n_gev, rescued (``_jax_per_lane``).
- The fixed-trip loop (``bounded=True``) equals the read-driven one bit
  for bit, for one instance and for a batch whose lanes end on different
  turns, and reads nothing on the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.linesearch import strategies as jax_ls
from tpu_lbfgs_torch.core.solver import make_phi
from tpu_lbfgs_torch.linesearch import strategies as ls

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

STRATEGIES = list(tt.config.LINE_SEARCH_METHODS)
INTERPOLATING = ("armijo_interpolation", "wolfe_interpolation",
                 "wolfe_interpolation_speculative")


def _cubics(n=40):
    """tests/test_speculative_ls.py: phi(a) = f_x + g.d a + q a^2 + c a^3
    with g.d < 0, float32."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        g_dot_d = -np.abs(rng.normal()) - 1e-3
        f_x, q, c = rng.normal(), rng.normal() * 10, rng.normal()
        out.append([f_x, g_dot_d, q, c])
    return np.array(out, np.float32)


def _polys():
    """tests/test_speculative_wolfe.py::POLYS, float64, padded to degree 4:
    accept at 1, long doubling ladders, zoom entries, growth."""
    rows = ([1.0, -1.0, 0.5], [1.0, -1.0, 0.005], [1.0, -1.0, 0.0005],
            [1.0, -2.0, 0.02], [5.0, -4.0, 2.0, -0.5, 0.03],
            [1.0, -0.1, 2.0], [1.0, -0.01, 8.0])
    return np.array([r + [0.0] * (5 - len(r)) for r in rows], np.float64)


BATCHES = {"cubics_f32": _cubics, "polys_f64": _polys}


def _cfg(strategy, fidelity="reference"):
    # ls_eval="direct": backtracking then runs its loop on one instance.
    return tt.LBFGSConfig(line_search=strategy, fidelity=fidelity, c2=0.9)


def _phis(coeffs: torch.Tensor):
    """phi / phi_dphi of make_phi over lanes whose directional polynomials
    are the rows of ``coeffs``; one instance for a 1-D ``coeffs``."""
    x = torch.zeros(coeffs.shape[:-1] + (1,), dtype=coeffs.dtype)
    cfg = tt.LBFGSConfig(ls_eval="polynomial")
    return make_phi(cfg, None, None, x, x, dir_poly=lambda x, d: coeffs)


def _search(strategy, cfg, coeffs, bounded):
    phi, phi_dphi = _phis(coeffs)
    ls.reset_host_reads()
    out = ls.get_line_search(strategy)(cfg, phi, phi_dphi, coeffs[..., 0],
                                       coeffs[..., 1], bounded=bounded)
    return out, ls.host_reads["line_search"]


def _jax_per_lane(strategy, fidelity):
    """The JAX package's search over coefficient rows, each row its own
    instance: ``jax.vmap`` of it, jitted, for a search whose alpha comes
    from an exact ladder; row by row and op by op (``jax.disable_jit``)
    for an interpolating search.  Jitted, XLA's CPU backend contracts a
    multiply and an add, which moves an interpolated alpha by an ulp
    (tests/test_torch_linesearch.py::_poly_searches); and ``jax.vmap`` of
    the search moves it even under ``disable_jit`` (the batched loop's body
    is compiled whole): on the float32 cubics it changed 3-7 of 40 lanes
    against the same search run row by row, and 2 of 7 float64 lanes of
    ``armijo_interpolation`` under "fixed".  The row-by-row run is what
    vmap's semantics promise, lane by lane."""
    cfg = tl.LBFGSConfig(line_search=strategy, fidelity=fidelity, c2=0.9)

    def one(c):
        d = c[1:] * jnp.arange(1, c.shape[0], dtype=c.dtype)

        def horner(k, a):
            acc = k[-1] * jnp.ones_like(a)
            for i in range(k.shape[0] - 2, -1, -1):
                acc = acc * a + k[i]
            return acc

        return jax_ls.get_line_search(strategy)(
            cfg, lambda a: horner(c, a),
            lambda a: (horner(c, a), horner(d, a)), c[0], c[1])

    if strategy not in INTERPOLATING:
        return jax.jit(jax.vmap(one))

    def rows(c):
        with jax.disable_jit():
            outs = [one(r) for r in c]
        return type(outs[0])(*(np.stack([np.asarray(o[i]) for o in outs])
                               for i in range(len(outs[0]))))
    return rows


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batched_search_matches_jax_per_lane(strategy, fidelity):
    """Each lane takes its own decisions, as under the reference's vmapped
    while_loop: alpha bit for bit and the counts equal, lane by lane, on
    both batches, under both loops (``_jax_per_lane``)."""
    run_j = _jax_per_lane(strategy, fidelity)
    cfg = _cfg(strategy, fidelity)
    for name, make in BATCHES.items():
        coeffs = make()
        ref = run_j(jnp.asarray(coeffs))
        for bounded in (False, True):
            out, _ = _search(strategy, cfg, torch.from_numpy(coeffs), bounded)
            assert out.alpha.shape == (coeffs.shape[0],), name
            assert out.alpha.dtype == torch.from_numpy(coeffs).dtype
            for field in ("alpha", "n_fev", "n_gev", "rescued"):
                np.testing.assert_array_equal(
                    getattr(out, field).numpy(),
                    np.asarray(getattr(ref, field)),
                    err_msg=f"{name} {field} bounded={bounded}")


def _assert_same(a, b, what):
    for field in ("alpha", "n_fev", "n_gev", "rescued"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, field)
        assert torch.equal(x, y), (what, field)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_fixed_trip_loop_equals_read_driven(strategy):
    """The fixed-trip loop runs the search's own trip bound with finished
    lanes frozen: the same result bit for bit as the read-driven loop,
    for one instance (each row alone) and for a batch whose lanes end on
    different turns, with no host read.  The read-driven loop reads once
    per turn, so on a batch it reads as often as its slowest lane needs."""
    cfg = _cfg(strategy)
    for name, make in BATCHES.items():
        coeffs = torch.from_numpy(make())
        read, n_read = _search(strategy, cfg, coeffs, False)
        fixed, n_fixed = _search(strategy, cfg, coeffs, True)
        _assert_same(read, fixed, name)
        assert n_fixed == 0, name
        if name == "polys_f64":     # its lanes end on different turns
            trials = set(read.n_fev.tolist())
            assert len(trials) > 1, trials
        for i, row in enumerate(coeffs):
            one_read, _ = _search(strategy, cfg, row, False)
            one_fixed, reads = _search(strategy, cfg, row, True)
            assert one_read.alpha.dim() == 0
            _assert_same(one_read, one_fixed, (name, i))
            assert reads == 0, (name, i)
            # A lane of the batch is the instance alone.
            assert one_read.alpha.item() == read.alpha[i].item(), (name, i)
            assert one_read.n_fev.item() == read.n_fev[i].item(), (name, i)
        if strategy != "backtracking":      # a batch's ladder reads nothing
            assert n_read >= 1, name


@pytest.mark.parametrize("strategy,cap_field", [
    ("backtracking_wolfe", "ls_safety_cap"),
    ("backtracking_wolfe_speculative", "ls_safety_cap"),
    ("backtracking_wolfe_bisect", "ls_max_iters"),
    ("armijo_interpolation", "ls_max_iters"),
    ("wolfe_interpolation", "ls_max_iters"),
    ("wolfe_interpolation_speculative", "ls_max_iters")])
def test_fixed_trip_loop_under_a_small_cap(strategy, cap_field):
    """Beside a lane that accepts its first trial, a lane whose step must
    shrink below 1e-6 (phi = -1e-3 a + 1e3 a^2) needs many trials: a cap of
    3 (spec_width 2 for the twins) stops it there, the default cap does
    not, and under either the fixed-trip loop's bound covers the lane
    and ends where the read-driven loop ends."""
    coeffs = torch.tensor([[0.0, -1.0, 0.5, 0.0, 0.0],       # accepts
                           [0.0, -1e-3, 1e3, 0.0, 0.0]],     # hard lane
                          dtype=torch.float64)
    for cap in (3, getattr(tt.LBFGSConfig(), cap_field)):
        cfg = _cfg(strategy).replace(**{cap_field: cap, "spec_width": 2})
        read, _ = _search(strategy, cfg, coeffs, False)
        fixed, reads = _search(strategy, cfg, coeffs, True)
        _assert_same(read, fixed, cap)
        assert reads == 0
        assert read.n_fev[0].item() < read.n_fev[1].item(), cap


def test_make_phi_lane_rule():
    """make_phi in direct mode over a batch: a (B,) step is one f pass
    over every lane, a (B, K) step K passes; a K-trial evaluator given for
    a batch takes the (B, K) step whole and gives (B, K), and a (B,) step
    still goes through f."""
    p = tt.get_problem("rosenbrock")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.uniform(-2, 2, (5, 16)))
    d = torch.from_numpy(rng.normal(size=(5, 16)))
    cfg = tt.LBFGSConfig(ls_eval="direct")
    phi, phi_dphi = make_phi(cfg, p.f, tt.make_value_and_grad(p.f, p.grad),
                             x, d)
    a = torch.from_numpy(rng.uniform(0, 1, (5, 3)))
    fs, dphis = phi_dphi(a)
    assert fs.shape == dphis.shape == (5, 3)
    for b in range(5):
        for k in range(3):
            xb = (x[b] + a[b, k] * d[b])[None]
            assert fs[b, k].item() == p.f(xb).item()
            assert dphis[b, k].item() == torch.linalg.vecdot(
                p.grad(xb), d[b][None]).item()
    assert torch.equal(phi(a), fs)
    assert torch.equal(phi(a[:, 1]), fs[:, 1])
    assert torch.equal(phi_dphi(a[:, 2])[1], dphis[:, 2])
    seen = []

    def phi_batch(xx, dd, aa):
        seen.append(aa)
        return torch.stack([p.f(xx + aa[:, k, None] * dd)
                            for k in range(aa.shape[-1])], dim=-1)

    phi_b, _ = make_phi(cfg, p.f, None, x, d, phi_batch=phi_batch)
    assert torch.equal(phi_b(a), fs)
    assert len(seen) == 1 and seen[0] is a
    assert torch.equal(phi_b(a[:, 1]), fs[:, 1]) and len(seen) == 1
