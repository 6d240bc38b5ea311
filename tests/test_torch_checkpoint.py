"""The port's checkpoints (tpu_lbfgs_torch.io) against the JAX package's:
one .npz file in both directions, exact round trips, and a resumed solve
equal to the uncut one (tests/test_checkpoint.py is the model)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.io import load_state as jax_load_state
from tpu_lbfgs.io import save_state as jax_save_state
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.io import load_state, save_state

torch.set_num_threads(1)

BENCH = dict(line_search="backtracking", direction="compact_incremental",
             m=10, use_pallas=True, ls_eval="polynomial")
FIELDS = [f.name for f in dataclasses.fields(tt.LBFGSState)]


def _torch_parts():
    p = tt.get_problem("rosenbrock")
    return (p, tt.fused_value_and_grad("rosenbrock"),
            tt.fused_tail_for("rosenbrock"))


def _torch_state(dtype, history_dtype=None, d=256, iters=7, seed=3):
    """A mid-solve port state on the CPU, its ring partly filled."""
    p, vg, tail = _torch_parts()
    cfg = tt.LBFGSConfig(**BENCH, history_dtype=history_dtype)
    x0 = torch.from_numpy(np.random.default_rng(seed).uniform(-2, 2, d))
    s = tt.init_state(vg, x0.to(dtype), cfg.m, history_dtype)
    for _ in range(iters):
        s = tt.iterate(cfg, p.f, vg, s, p.dir_poly, tail)
    return s


def _assert_states_equal(a, b):
    for name in FIELDS:
        ta, tb = getattr(a, name), getattr(b, name)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, name
        assert torch.equal(ta, tb), name


def _np_state(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def _jax_state(dtype, history_dtype=None, d=256, iters=7, seed=3):
    p = tl.get_problem("rosenbrock")
    vg = tl.fused_value_and_grad("rosenbrock", use_pallas=False)
    tail = tl.fused_tail_for("rosenbrock", with_matvec=False,
                             use_pallas=False)
    cfg = tl.LBFGSConfig(**{**BENCH, "use_pallas": False},
                         history_dtype=history_dtype)
    x0 = jnp.asarray(np.random.default_rng(seed).uniform(-2, 2, d), dtype)
    s = tl.init_state(vg, x0, cfg.m, history_dtype)
    step = jax.jit(lambda s: tl.iterate(cfg, p.f, vg, s, p.dir_poly, tail))
    for _ in range(iters):
        s = step(s)
    return s


RINGS = [(torch.float32, None), (torch.float64, None),
         (torch.float32, "bfloat16")]


@pytest.mark.parametrize("dtype,history_dtype", RINGS,
                         ids=["f32", "f64", "bf16_ring"])
def test_round_trip_is_bit_exact(tmp_path, dtype, history_dtype):
    s = _torch_state(dtype, history_dtype)
    assert s.n_pairs.item() > 0 and s.s_hist.abs().sum() > 0
    path = tmp_path / "ck.npz"
    save_state(path, s)
    back = load_state(path, device="cpu")
    _assert_states_equal(s, back)
    assert back.s_hist.dtype == (torch.bfloat16 if history_dtype
                                 else dtype)
    assert not list(tmp_path.glob("*.tmp"))


def test_file_holds_the_reference_layout(tmp_path):
    s = _torch_state(torch.float32, "bfloat16", d=512)
    save_state(tmp_path / "ck.npz", s)
    with np.load(tmp_path / "ck.npz") as z:
        assert str(z["__schema__"]) == "tpu-lbfgs-state-v1"
        assert z["s_hist"].shape == (10, 4, 128)       # (m, R, L)
        assert z["s_hist"].dtype == np.float32
        assert str(z["__casts__"]) == \
            '{"s_hist": "bfloat16", "y_hist": "bfloat16"}'
        assert set(z.files) == set(FIELDS) | {"__schema__", "__casts__"}


@pytest.mark.parametrize("dtype,history_dtype",
                         [(jnp.float64, None), (jnp.float32, None),
                          (jnp.float32, "bfloat16")],
                         ids=["f64", "f32", "bf16_ring"])
def test_a_jax_file_loads_in_the_port(tmp_path, dtype, history_dtype):
    """JAX's save_state, the port's load_state: equal to
    interop.state_from_numpy of the same JAX state, exactly."""
    sj = _jax_state(dtype, history_dtype)
    jax_save_state(tmp_path / "jax.npz", sj)
    got = load_state(tmp_path / "jax.npz", device="cpu")
    want = interop.state_from_numpy(_np_state(sj), device="cpu")
    _assert_states_equal(got, want)
    if history_dtype:
        assert got.s_hist.dtype == torch.bfloat16


@pytest.mark.parametrize("dtype,history_dtype", RINGS,
                         ids=["f32", "f64", "bf16_ring"])
def test_a_port_file_loads_in_jax(tmp_path, dtype, history_dtype):
    """The port's save_state, JAX's load_state: equal to the port's state
    through interop.state_to_numpy, exactly, the ring back in bfloat16."""
    s = _torch_state(dtype, history_dtype)
    save_state(tmp_path / "port.npz", s)
    sj = jax_load_state(tmp_path / "port.npz")
    want = interop.state_to_numpy(s)
    for name in FIELDS:
        got = np.asarray(getattr(sj, name))
        if history_dtype and name in ("s_hist", "y_hist"):
            assert getattr(sj, name).dtype == jnp.bfloat16
            got = got.astype(np.float32)
        assert got.dtype == want[name].dtype, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)


@pytest.mark.parametrize("refresh", [None, 20])
def test_resume_equals_the_uncut_segments(tmp_path, refresh):
    """A float64 solve in two make_solve_segment segments of 20 and 25
    iterations, cut at k = 20 by save_state / load_state, equals the same
    segments uncut, bit for bit; with refresh_interval the products are
    refreshed at each segment's end in both."""
    p, vg, tail = _torch_parts()
    cfg = tt.LBFGSConfig(**BENCH, max_iters=45, tol=0.0,
                         refresh_interval=refresh)
    x0 = torch.from_numpy(np.random.default_rng(5).uniform(-2, 2, 384))

    def segments():
        kw = dict(value_and_grad=vg, dir_poly=p.dir_poly, fused_tail=tail)
        return (tt.make_solve_segment(cfg, p.f, iters=20, **kw),
                tt.make_solve_segment(cfg, p.f, iters=25, **kw))

    first, second = segments()
    uncut = second(first(tt.init_state(vg, x0.clone(), cfg.m)))
    first, second = segments()
    mid = first(tt.init_state(vg, x0.clone(), cfg.m))
    assert mid.k.item() == 20
    save_state(tmp_path / "mid.npz", mid)
    del mid
    resumed = second(load_state(tmp_path / "mid.npz", device="cpu"))
    assert resumed.k.item() == 45
    _assert_states_equal(resumed, uncut)


def _rel(a, b):
    return abs(a - b) / abs(a)


def test_a_jax_mid_solve_file_resumes_in_the_port(tmp_path):
    """JAX solves 20 float64 iterations of the main path's configuration
    and saves; the port loads the file and takes 40 more iterations beside
    JAX's straight run: equal alpha, status, n_pairs and guard counters at
    every one, f and g_norm within tests/test_torch_solver.py's bound (1e-9
    or 100x the deviation of a JAX run from the same state with every
    seventh coordinate of x moved by one ulp)."""
    cfg_j = tl.LBFGSConfig(**BENCH)
    cfg_t = tt.LBFGSConfig(**BENCH)
    pj = tl.get_problem("rosenbrock")
    vgj = tl.fused_value_and_grad("rosenbrock", use_pallas=True)
    tailj = tl.fused_tail_for("rosenbrock", with_matvec=False,
                              use_pallas=True)
    step = jax.jit(lambda s: tl.iterate(cfg_j, pj.f, vgj, s, pj.dir_poly,
                                        tailj))
    x0 = -1.2 + np.random.default_rng(1).uniform(-0.1, 0.1, 1024)
    sj = tl.init_state(vgj, jnp.asarray(x0), cfg_j.m)
    for _ in range(20):
        sj = step(sj)
    jax_save_state(tmp_path / "jax_mid.npz", sj)
    st = load_state(tmp_path / "jax_mid.npz", device="cpu")
    assert st.k.item() == 20 and st.x.dtype == torch.float64
    x1 = np.asarray(sj.x).copy()
    x1[::7] = np.nextafter(x1[::7], np.inf)
    sp = sj._replace(x=jnp.asarray(x1))
    p, vg, tail = _torch_parts()
    for k in range(40):
        sj, sp = step(sj), step(sp)
        st = tt.iterate(cfg_t, p.f, vg, st, p.dir_poly, tail)
        assert st.alpha.item() == float(sj.alpha), k
        assert st.status.item() == int(sj.status), k
        assert st.n_pairs.item() == int(sj.n_pairs), k
        assert st.guards.tolist() == np.asarray(sj.guards).tolist(), k
        assert st.n_fev.item() == int(sj.n_fev), k
        for name in ("f", "g_norm"):
            ref = float(getattr(sj, name))
            bound = max(1e-9, 100 * _rel(ref, float(getattr(sp, name))))
            assert _rel(ref, getattr(st, name).item()) <= bound, (k, name)
    assert st.k.item() == 60


def test_bad_schema_rejected(tmp_path):
    path = tmp_path / "bogus.npz"
    np.savez(path, __schema__=np.asarray("something-else"),
             **{name: np.zeros(1) for name in FIELDS})
    with pytest.raises(ValueError, match="schema"):
        load_state(path, device="cpu")


@pytest.mark.parametrize("guards", ["missing", "short"])
def test_guards_are_zero_extended(tmp_path, guards):
    s = _torch_state(torch.float64, iters=3)
    arrays = interop.state_to_numpy(s)
    if guards == "missing":
        del arrays["guards"]
    else:
        arrays["guards"] = arrays["guards"][:4] + 1
    path = tmp_path / "old.npz"
    np.savez(path, __schema__=np.asarray("tpu-lbfgs-state-v1"), **arrays)
    back = load_state(path, device="cpu")
    want = [0] * tt.Guard.N if guards == "missing" else \
        (arrays["guards"].tolist() + [0] * (tt.Guard.N - 4))
    assert back.guards.tolist() == want
    assert back.guards.dtype == torch.int32
    assert torch.equal(back.x, s.x) and torch.equal(back.s_hist, s.s_hist)


def test_load_casts_to_a_dtype_and_needs_a_device_by_default(tmp_path):
    s = _torch_state(torch.float32, "bfloat16")
    save_state(tmp_path / "ck.npz", s)
    wide = load_state(tmp_path / "ck.npz", dtype="float64", device="cpu")
    assert wide.x.dtype == wide.s_hist.dtype == torch.float64
    assert wide.k.dtype == torch.int32
    assert torch.equal(wide.s_hist, s.s_hist.double())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_state(tmp_path / "ck.npz")
