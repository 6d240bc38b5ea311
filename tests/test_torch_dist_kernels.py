"""The shard-local forms of the four fused kernel families against the JAX
package, in one process on the CPU (no process group).

On the CPU the port's shard-local wrappers run their plain PyTorch versions
(``dist.shardmap_vg``'s chunks, ``fused_tail_local_plain``,
``multi_phi_local_plain``, ``multi_phi_dphi_local_plain``) and the JAX
package's Pallas kernels run in interpret mode with the same ``n``,
``start`` and ``edges`` (tests/conftest.py forces the cpu backend).
chip_smoke.py holds the CUDA kernels to these plain versions on the GPU.

Part (a): each plain shard-local version against the interpreted Pallas
kernel of that shard.  Part (b): the shards joined against the port's
whole-vector plain versions, and the shard-local ``dir_poly`` against the
suite's.  Part (c): the repairs that came with this slice (the dtype rule
of the problem-specific kernels, the tail's products at any history depth,
``bench_gpu``'s callables).  Inputs come from numpy.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs.kernels.pallas_ops import (
    LANES,
    _fused_tail_pallas,
    _multi_phi_dphi_pallas,
    _multi_phi_pallas,
    local_block_rows,
    local_fused_vg as jax_local_fused_vg,
)
from tpu_lbfgs_torch.bench import harness
from tpu_lbfgs_torch.dist import shardmap_vg, sharded
from tpu_lbfgs_torch.kernels import fused_ops, line_search_ops

torch.set_num_threads(1)

BODIES = ["quadratic", "rosenbrock", "coupled_quadratic"]
SHARDS = 4
D_LOCAL = 1024              # whole (8, 128) tiles, as the Pallas kernels need
D_PAD = SHARDS * D_LOCAL
# The global unpadded length: aligned, and one that leaves shard 2 partly
# and shard 3 wholly in the zero-padded tail.  With each, the shards that
# are compared: the two ends of the vector and an inner shard; the two
# shards the padding reaches.
CASES = [(D_PAD, 0), (D_PAD, 1), (D_PAD, 3), (2900, 2), (2900, 3)]
# Pallas (interpret mode) against the plain version, both float32: the two
# sum in different orders and accumulators (float32 blocks there, float64
# here), so the tolerances are those of the reference's own Pallas-vs-jnp
# test (tests/test_tail_fused.py::test_pallas_matches_jnp), as in
# tests/test_torch_suite_kernels.py.
RTOL_F32, ATOL_F32 = 2e-5, 1e-4
M = 3
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _global(n, seed=0):
    """x, d, g and an (M, D_PAD) ring, float32, zero beyond n."""
    rng = np.random.default_rng(seed)
    out = []
    for lo, hi, shape in ((-2, 2, D_PAD), (-1, 1, D_PAD), (-1, 1, D_PAD),
                          (-1, 1, (M, D_PAD)), (-1, 1, (M, D_PAD))):
        a = rng.uniform(lo, hi, shape).astype(np.float32)
        a[..., n:] = 0.0
        out.append(a)
    return out


def _edges(x, d, r, d_local=D_LOCAL):
    """[prev x, prev d, next x, next d] of shard r, wrapping around."""
    lo, hi = r * d_local - 1, ((r + 1) * d_local) % x.shape[-1]
    return np.array([x[lo], d[lo], x[hi], d[hi]], x.dtype)


def _local(a, r, d_local=D_LOCAL):
    return np.ascontiguousarray(a[..., r * d_local:(r + 1) * d_local])


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def _close(a, b, what):
    np.testing.assert_allclose(_f32(a), _f32(b), rtol=RTOL_F32,
                               atol=ATOL_F32, err_msg=what)


BR = local_block_rows(D_LOCAL // LANES)


# --- (a) plain shard-local versions against the interpreted Pallas kernels --

@pytest.mark.parametrize("n,r", CASES)
@pytest.mark.parametrize("problem", BODIES)
def test_local_vg_plain_matches_pallas(problem, n, r):
    x, d, *_ = _global(n)
    e = _edges(x, d, r)[[0, 2]]
    start = r * D_LOCAL
    f_ref, g_ref = jax_local_fused_vg(problem, jnp.asarray(_local(x, r)), n,
                                      start, jnp.asarray(e), BR)
    f, g = fused_ops.local_fused_vg(problem, torch.from_numpy(_local(x, r)),
                                    n, start, torch.from_numpy(e))
    assert f.dtype == torch.float64 and g.dtype == torch.float32
    _close(f, f_ref, "f partial")
    _close(g, g_ref, "g")
    if start >= n:      # a shard wholly in the padded tail
        assert f.item() == 0.0 and not g.any()


@pytest.mark.parametrize("with_matvec,hist", [(False, "float32"),
                                              (True, "float32"),
                                              (True, "bfloat16"),
                                              (False, "bfloat16")])
@pytest.mark.parametrize("n,r", CASES)
@pytest.mark.parametrize("problem", BODIES)
def test_local_tail_plain_matches_pallas(problem, n, r, with_matvec, hist):
    x, d, g, S, Y = _global(n, seed=1)
    e = _edges(x, d, r)
    start = r * D_LOCAL
    alpha = np.float32(0.37)
    loc = [_local(a, r) for a in (x, d, g, S, Y)]
    jS, jY = (jnp.asarray(a).astype(getattr(jnp, hist)) for a in loc[3:])
    ref = _fused_tail_pallas(
        problem, *(jnp.asarray(a) for a in loc[:2]), jnp.asarray(alpha),
        jnp.asarray(loc[2]), jS, jY, with_matvec, n=n, start=start,
        edges=jnp.asarray(e), br=BR)
    tx, td, tg = (torch.from_numpy(a) for a in loc[:3])
    tS, tY = (torch.from_numpy(a).to(TORCH_DTYPE[hist]) for a in loc[3:])
    x_new, g_new, s_row, y_row, sums = fused_ops.local_fused_tail(
        problem, tx, td, torch.tensor(alpha), tg, tS, tY, with_matvec, n,
        start, torch.from_numpy(e))
    assert sums.dtype == torch.float64
    assert sums.shape == (7 + 2 * M * with_matvec,)
    assert s_row.dtype == y_row.dtype == TORCH_DTYPE[hist]
    for got, want, name in ((x_new, ref[0], "x_new"), (g_new, ref[2], "g_new"),
                            (s_row, ref[3], "s_row"), (y_row, ref[4], "y_row")):
        _close(got, want, name)
    _close(sums[0], ref[1], "f partial")
    for i, name in enumerate(("sy", "yy", "gg", "dgn", "ggn", "ygn")):
        _close(sums[1 + i], ref[5 + i], name)
    if with_matvec:
        _close(sums[7:7 + M], ref[11], "t1")
        _close(sums[7 + M:], ref[12], "t2")
    else:
        assert ref[11] is None and ref[12] is None


@pytest.mark.parametrize("n,r", CASES)
@pytest.mark.parametrize("problem", BODIES)
def test_local_multi_phi_plain_matches_pallas(problem, n, r):
    x, d, *_ = _global(n, seed=2)
    e4 = _edges(x, d, r)
    start = r * D_LOCAL
    alphas = np.array([0.01, 0.25, 0.5, 1.0, 1.7], np.float32)
    jx, jd = jnp.asarray(_local(x, r)), jnp.asarray(_local(d, r))
    tx, td = torch.from_numpy(_local(x, r)), torch.from_numpy(_local(d, r))
    ta = torch.from_numpy(alphas)
    phi_ref = _multi_phi_pallas(problem, jx, jd, jnp.asarray(alphas), n=n,
                                start=start, edges=jnp.asarray(e4[2:]), br=BR)
    phi = line_search_ops.local_multi_phi(problem, tx, td, ta, n, start,
                                          torch.from_numpy(e4[2:].copy()))
    assert phi.dtype == torch.float64 and phi.shape == (5,)
    _close(phi, phi_ref, "phi partials")
    f_ref, dphi_ref = _multi_phi_dphi_pallas(
        problem, jx, jd, jnp.asarray(alphas), n=n, start=start,
        edges=jnp.asarray(e4), br=BR)
    f, dphi = line_search_ops.local_multi_phi_dphi(
        problem, tx, td, ta, n, start, torch.from_numpy(e4))
    assert f.dtype == dphi.dtype == torch.float64
    _close(f, f_ref, "phi partials of phi_dphi")
    _close(dphi, dphi_ref, "dphi partials")


# The batched shard-local K-trial plain version (the one the batched CUDA
# kernel is held to on the card) on LANES_B lanes, each with its own
# alphas, at K that fill a row of the kernel's (8 or 18 trials), leave one
# partly empty, or take two rows.
LANES_B = 3
BATCH_K = [1, 8, 9, 19, 36]
# A d_local that is not a multiple of 4 (the kernel's element path) and a
# global n that ends shard 3 in two elements of padding.
RAGGED_LOCAL = D_LOCAL - 1
RAGGED_N = SHARDS * RAGGED_LOCAL - 2


# The interpreted Pallas kernel under jit, n and start traced, so that one
# compilation per problem, K and block length serves every shard and lane.
_pallas_phi_dphi = jax.jit(
    lambda problem, x, d, a, n, start, edges, br: _multi_phi_dphi_pallas(
        problem, x, d, a, n=n, start=start, edges=edges, br=br),
    static_argnums=(0, 7))


def _lanes(n, d_local, k, seed):
    """LANES_B lanes of x ~ U(-2, 2), d ~ U(-1, 1), float32, zero beyond
    n in a vector of SHARDS * d_local, and (LANES_B, K) alphas in
    [0.01, 1.7]."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-2, 2, (LANES_B, SHARDS * d_local)).astype(np.float32)
    d = rng.uniform(-1, 1, (LANES_B, SHARDS * d_local)).astype(np.float32)
    x[:, n:] = d[:, n:] = 0.0
    alphas = rng.uniform(0.01, 1.7, (LANES_B, k)).astype(np.float32)
    return x, d, alphas


def _batched_phi_dphi(problem, x, d, alphas, n, r, d_local):
    """The batched plain version on shard r of every lane: (K, B) f and
    dphi partials, and the (B, 4) edges it was given."""
    e4 = np.stack([_edges(x[j], d[j], r, d_local) for j in range(LANES_B)])
    f, dphi = line_search_ops.multi_phi_dphi_local_plain(
        problem, torch.from_numpy(_local(x, r, d_local)),
        torch.from_numpy(_local(d, r, d_local)), torch.from_numpy(alphas), n,
        r * d_local, torch.from_numpy(e4))
    assert f.dtype == dphi.dtype == torch.float64
    assert f.shape == dphi.shape == (LANES_B, alphas.shape[1])
    return f, dphi, e4


@pytest.mark.parametrize("r", [0, 1, SHARDS - 1])
@pytest.mark.parametrize("k", BATCH_K)
@pytest.mark.parametrize("problem", BODIES)
def test_batched_local_multi_phi_dphi_plain_matches_pallas(problem, k, r):
    """Each lane of the batch against the interpreted Pallas kernel on that
    lane's shard alone, in the first, a middle and the last shard."""
    x, d, alphas = _lanes(D_PAD, D_LOCAL, k, seed=40 + k)
    f, dphi, e4 = _batched_phi_dphi(problem, x, d, alphas, D_PAD, r, D_LOCAL)
    for j in range(LANES_B):
        f_ref, dphi_ref = _pallas_phi_dphi(
            problem, _local(x[j], r), _local(d[j], r), alphas[j], D_PAD,
            r * D_LOCAL, e4[j], BR)
        _close(f[j], f_ref, f"lane {j} phi partials")
        _close(dphi[j], dphi_ref, f"lane {j} dphi partials")


@pytest.mark.parametrize("k", BATCH_K)
@pytest.mark.parametrize("problem", BODIES)
def test_batched_local_multi_phi_dphi_plain_ragged(problem, k):
    """A d_local of 1023.  The Pallas kernel takes whole (8, 128) tiles, so
    it sees a shard of 1023 only where the rest of its tile owns nothing:
    the last shard, zero-padded to 1024, whose global indices from 1023 on
    are past n.  The first and middle shards are held to it through the
    whole vector: each lane's partials over the four shards added against
    the reference's own sharded sum at the same n, its kernel on four
    blocks of 1024 of the vector padded as the reference pads it."""
    x, d, alphas = _lanes(RAGGED_N, RAGGED_LOCAL, k, seed=60 + k)
    parts = [_batched_phi_dphi(problem, x, d, alphas, RAGGED_N, r,
                               RAGGED_LOCAL) for r in range(SHARDS)]
    f_last, dphi_last, e4 = parts[-1]
    start = (SHARDS - 1) * RAGGED_LOCAL
    pad = ((0, 0), (0, D_LOCAL - RAGGED_LOCAL))
    x_last, d_last = (np.pad(_local(a, SHARDS - 1, RAGGED_LOCAL), pad)
                      for a in (x, d))
    whole = ((0, 0), (0, D_PAD - SHARDS * RAGGED_LOCAL))
    x_all, d_all = np.pad(x, whole), np.pad(d, whole)
    for j in range(LANES_B):
        f_ref, dphi_ref = _pallas_phi_dphi(
            problem, x_last[j], d_last[j], alphas[j], RAGGED_N, start, e4[j],
            BR)
        _close(f_last[j], f_ref, f"lane {j} last shard phi partials")
        _close(dphi_last[j], dphi_ref, f"lane {j} last shard dphi partials")
        f_ref, dphi_ref = (sum(p) for p in zip(*(_pallas_phi_dphi(
            problem, _local(x_all[j], r), _local(d_all[j], r), alphas[j],
            RAGGED_N, r * D_LOCAL, _edges(x_all[j], d_all[j], r), BR)
            for r in range(SHARDS))))
        _close(sum(p[0][j] for p in parts), f_ref, f"lane {j} phi")
        _close(sum(p[1][j] for p in parts), dphi_ref, f"lane {j} dphi")


# --- (b) the shards joined against the whole-vector plain versions ----------

def _sharded(n, shards, dtype, seed=3, m=4):
    """Whole (n,) inputs in ``dtype`` and each shard's padded block."""
    rng = np.random.default_rng(seed)
    whole = [torch.from_numpy(rng.uniform(lo, hi, shape)).to(dtype)
             for lo, hi, shape in ((-2, 2, n), (-1, 1, n), (-1, 1, n),
                                   (-1, 1, (m, n)), (-1, 1, (m, n)))]
    pad = (-n) % shards
    padded = [torch.nn.functional.pad(t, (0, pad)) for t in whole]
    return whole, padded, (n + pad) // shards


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,shards", [(64, 4), (61, 4), (61, 3), (9, 4)])
@pytest.mark.parametrize("problem", BODIES)
def test_shards_join_to_the_whole_vector(problem, n, shards, dtype):
    """Vectors bit for bit; sums to 1e-12 of the whole-vector value in
    float64 (the float32 whole-vector sums are rounded once to float32: one
    ulp, 1.2e-7)."""
    (x, d, g, S, Y), (xp, dp, gp, Sp, Yp), d_local = _sharded(n, shards,
                                                             dtype)
    alpha = torch.tensor(0.37, dtype=dtype)
    alphas = torch.tensor([0.01, 0.5, 1.3], dtype=dtype)
    rtol = 1e-12 if dtype == torch.float64 else 1.2e-7
    f_w, g_w = fused_ops.VG_PLAIN[problem](x)
    tail_w = fused_ops.fused_tail_plain(fused_ops.VG_PLAIN[problem], x, d,
                                        alpha, g, S, Y, with_matvec=True)
    phi_w = line_search_ops.multi_phi_plain(fused_ops.F_PLAIN[problem], x, d,
                                            alphas)
    fk_w, dphi_w = line_search_ops.multi_phi_dphi_plain(
        fused_ops.VG_PLAIN[problem], x, d, alphas)
    joined = [[] for _ in range(5)]
    f_sum = tail_sum = phi_sum = fk_sum = dphi_sum = 0.0
    for r in range(shards):
        start = r * d_local
        e4 = torch.from_numpy(_edges(xp.numpy(), dp.numpy(), r, d_local))
        xl, dl, gl, Sl, Yl = (t[..., start:start + d_local]
                              for t in (xp, dp, gp, Sp, Yp))
        f_p, g_l = shardmap_vg.local_vg_plain(problem, xl, n, start,
                                              e4[[0, 2]])
        out = fused_ops.fused_tail_local_plain(problem, xl, dl, alpha, gl, Sl,
                                               Yl, True, n, start, e4)
        for vec, part in zip(joined, (g_l, *out[:4])):
            vec.append(part)
        f_sum, tail_sum = f_sum + f_p, tail_sum + out[4]
        phi_sum = phi_sum + line_search_ops.multi_phi_local_plain(
            problem, xl, dl, alphas, n, start, e4[2:])
        fk, dk = line_search_ops.multi_phi_dphi_local_plain(
            problem, xl, dl, alphas, n, start, e4)
        fk_sum, dphi_sum = fk_sum + fk, dphi_sum + dk
    whole = (g_w, tail_w[0], tail_w[2], tail_w[3], tail_w[4])
    for vec, want in zip(joined, whole):
        got = torch.cat(vec)
        assert torch.equal(got[:n], want)
    for vec in (joined[0], joined[2], joined[3], joined[4]):
        assert not torch.cat(vec)[n:].any()     # g, g_new, s, y of the pad
    tail_w_sums = torch.cat([torch.stack([tail_w[1], *tail_w[5:11]]),
                             tail_w[11], tail_w[12]])
    for got, want in ((f_sum, f_w), (tail_sum, tail_w_sums),
                      (phi_sum, phi_w), (fk_sum, fk_w), (dphi_sum, dphi_w)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want.double().numpy(),
                                   rtol=rtol, atol=rtol)


@pytest.mark.parametrize("n,shards", [(64, 4), (61, 4), (61, 3), (9, 4)])
@pytest.mark.parametrize("problem", BODIES + ["sphere"])
def test_local_dir_poly_matches_the_suite(problem, n, shards):
    """The shards' coefficient partials add up to ``Problem.dir_poly`` on
    the unpadded vector: 1e-12 relative in float64."""
    (x, d, *_), (xp, dp, *_), d_local = _sharded(n, shards, torch.float64)
    want = tt.get_problem(problem).dir_poly(x, d)
    got = 0.0
    for r in range(shards):
        e4 = torch.from_numpy(_edges(xp.numpy(), dp.numpy(), r, d_local))
        sl = slice(r * d_local, (r + 1) * d_local)
        got = got + shardmap_vg.DIR_POLY_CHUNKS[problem](
            xp[sl], dp[sl], e4[2], e4[3], n, r * d_local)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * float(want.abs().max()))
    # and it is the polynomial of f along d
    a = 0.3
    f = tt.get_problem(problem).f(x + a * d)
    poly = sum(c * a ** k for k, c in enumerate(got.tolist()))
    assert poly == pytest.approx(f.item(), rel=1e-10)


def test_padded_rosenbrock_would_differ():
    """The crossing term at the pad boundary is why ownership goes by the
    global index: f of the zero-padded vector is another function."""
    (x, *_), (xp, *_), _ = _sharded(61, 4, torch.float64)
    f = tt.get_problem("rosenbrock").f
    assert abs(f(xp).item() - f(x).item()) > 1.0


# --- (c) the repairs of this slice ------------------------------------------

@pytest.mark.parametrize("dtype,device,ok", [
    (torch.float32, "meta", True), (torch.float64, "meta", False),
    (torch.bfloat16, "meta", False), (torch.float32, "cpu", True),
    (torch.float64, "cpu", False)])
def test_problem_kernels_take_float32_off_the_cpu_only(dtype, device, ok):
    """The reference's ``pallas_ok`` rule, for the caller that chooses
    ``use_pallas``: the problem-specific kernels are float32 programs, on
    either device alike; another dtype warns and answers False.  The
    wrappers keep no such rule: a tensor that is not on the CPU (a meta
    tensor stands in for a CUDA one) goes on to the launch whatever its
    dtype, and raises there."""
    assert fused_ops.pallas_ok(dtype) is ok
    if ok:
        assert tt.problems.suite.resolve_use_pallas(True, dtype, "t") is True
    else:
        with pytest.warns(UserWarning, match="float32 programs"):
            assert tt.problems.suite.resolve_use_pallas(
                True, dtype, "t") is False
    assert tt.problems.suite.resolve_use_pallas(False, dtype, "t") is False
    x = torch.empty(8, dtype=dtype, device=device)
    if device == "meta":
        with pytest.raises(ValueError, match="CUDA"):
            tt.fused_value_and_grad("rosenbrock")(x)
        with pytest.raises(ValueError, match="CUDA"):
            tt.fused_tail_for("rosenbrock")(x, x, x[:1], x)
    else:
        assert tt.fused_value_and_grad("rosenbrock")(x)[1].shape == (8,)


@pytest.mark.parametrize("problem", BODIES)
def test_float64_takes_the_plain_versions_where_float32_launches(problem):
    """``--pallas --dtype float64`` off the CPU runs the plain versions
    because its caller says so (``bench_gpu``'s and the command line's
    callables come from ``resolve_use_pallas``, with a warning): on a
    float64 meta tensor each of them returns and nothing is launched, where
    the float32 ones go on to the launch and fail on the device check."""
    cfg = tt.LBFGSConfig(use_pallas=True, ls_eval="direct",
                         line_search="backtracking_speculative")
    wolfe = cfg.replace(line_search="wolfe_interpolation_speculative")
    with pytest.warns(UserWarning, match="float32 programs"):
        vg, _, tail, phi_batch, _ = harness.solve_callables(
            problem, 8, cfg, torch.float64)
        phi_dphi_batch = harness.solve_callables(
            problem, 8, wolfe, torch.float64)[4]
    x = torch.empty(8, dtype=torch.float64, device="meta")
    a = torch.empty((), dtype=torch.float64, device="meta")
    ks = torch.empty(3, dtype=torch.float64, device="meta")
    f, g = vg(x)
    assert f.dtype == g.dtype == torch.float64 and g.shape == (8,)
    out = tail(x, x, a, x)
    assert out[0].shape == (8,) and out[11] is None
    assert phi_batch(x, x, ks).shape == (3,)
    assert phi_dphi_batch(x, x, ks)[1].shape == (3,)
    assert not any(fused_ops.launches.values())
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        vg32, _, tail32, phi32, _ = harness.solve_callables(
            problem, 8, cfg, torch.float32)
    x32 = torch.empty(8, dtype=torch.float32, device="meta")
    for call in (lambda: vg32(x32), lambda: tail32(x32, x32, x32[:1], x32),
                 lambda: phi32(x32, x32, x32[:3])):
        with pytest.raises(ValueError, match="CUDA"):
            call()


def test_cli_pallas_float64_warns_and_runs_the_plain_versions(capsys):
    argv = ("--device cpu --problem rosenbrock --dim 48 --max-iters 5 "
            "--pallas --poly-ls --direction compact_incremental --json")
    from tpu_lbfgs_torch import cli
    with pytest.warns(UserWarning, match="--pallas.*float32 programs"):
        assert cli.main((argv + " --dtype float64").split()) == 0
    f64 = json.loads(capsys.readouterr().out)["results"][0]
    assert f64["iterations"] == 5 and np.isfinite(f64["f"])
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert cli.main((argv + " --dtype float32").split()) == 0


@pytest.mark.parametrize("m", [3, 7, 10])
def test_tail_products_at_any_history_depth(m):
    """The tail's history products take any history depth, as the
    reference's kernel does: ``fused_tail_for(with_matvec=True, m=m)``
    builds them without a warning, t1 and t2 equal the solver's own two
    float64 products of the ring and y, and the solve with them takes the
    alphas of the solve without them; ``sharded_minimize``'s rule keeps
    them.  The wrapper itself raises for a ring that is neither on the CPU
    nor on the card."""
    import warnings

    from tpu_lbfgs_torch.core.solver import _matvec

    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.uniform(-2, 2, 96))
    S, Y = (torch.from_numpy(rng.uniform(-1, 1, (m, 96))) for _ in range(2))
    a = torch.tensor(0.1, dtype=torch.float64)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with_t = tt.fused_tail_for("rosenbrock", with_matvec=True, m=m)
        out = with_t(x0, x0, a, x0, S, Y)
    plain = tt.fused_tail_for("rosenbrock", with_matvec=False, m=m)(
        x0, x0, a, x0, S, Y)
    assert out[11] is not None and out[12] is not None and plain[11] is None
    for i in range(11):
        assert torch.equal(out[i], plain[i])
    y = plain[4]
    for t, ring in ((out[11], S), (out[12], Y)):
        assert t.shape == (m,)
        torch.testing.assert_close(t, _matvec(ring, y, torch.float64),
                                   rtol=1e-13, atol=1e-13)
    p = tt.get_problem("rosenbrock")
    cfg = tt.LBFGSConfig(m=m, direction="compact_incremental", max_iters=25,
                         tol=0.0, line_search="backtracking",
                         ls_eval="polynomial", record_trace=True)
    vg = tt.fused_value_and_grad("rosenbrock")
    runs = [tt.minimize(p.f, x0, cfg, value_and_grad=vg, dir_poly=p.dir_poly,
                        fused_tail=tt.fused_tail_for("rosenbrock",
                                                     with_matvec=wm, m=m))
            for wm in (True, False)]
    assert torch.equal(runs[0].trace.alpha, runs[1].trace.alpha)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert sharded._resolve_shard_local(
            cfg, 96, 4, torch.float32, True)[1] is True
    x32 = torch.empty(96, dtype=torch.float32, device="meta")
    S32 = torch.empty(m, 96, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_ops.make_fused_tail("rosenbrock", None, with_matvec=True)(
            x32, x32, x32[:1], x32, S32, S32)


def test_solve_cases_runs_on_the_card_unless_asked_for_the_cpu():
    """``dist.launch.solve_cases`` takes no tensor, so it follows the
    port's device rule: the current CUDA device, and without one it raises
    (``device="cpu"`` asks for the CPU)."""
    import inspect

    from tpu_lbfgs_torch.dist import launch

    sig = inspect.signature(launch.solve_cases)
    assert sig.parameters["device"].default is None
    assert inspect.signature(
        launch.spawn_ranks).parameters["backend"].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.solve_cases(0, 1, [])
    assert launch.solve_cases(0, 1, [], "cpu") == []


@pytest.mark.parametrize("search,ls_eval,expect", [
    ("backtracking", "polynomial", (True, False, False)),
    ("backtracking", "direct", (False, False, False)),
    ("backtracking_speculative", "direct", (False, True, False)),
    ("wolfe_interpolation_speculative", "direct", (False, False, True)),
    ("backtracking_wolfe_speculative", "direct", (False, False, True)),
    ("backtracking_speculative", "polynomial", (True, False, False)),
])
def test_bench_gpu_hands_the_solver_what_bench_tpu_does(search, ls_eval,
                                                        expect):
    """``bench_gpu``'s callables by ``bench_tpu``'s rules: dir_poly only on
    the polynomial, the K-trial evaluator of a speculative search in direct
    mode, a tail that carries ``cfg.accurate_dots``; nothing fused without
    ``use_pallas``."""
    cfg = tt.LBFGSConfig(line_search=search, ls_eval=ls_eval, use_pallas=True,
                         accurate_dots=True, m=5, history_dtype="bfloat16")
    vg, dir_poly, tail, phi_batch, phi_dphi_batch = harness.solve_callables(
        "rosenbrock", 1 << 20, cfg, torch.float32, with_matvec="auto")
    assert ((dir_poly is not None), (phi_batch is not None),
            (phi_dphi_batch is not None)) == expect
    assert tail.accurate_dots is True
    # "auto" saw m = 5, d = 2^20 and the bf16 ring: the products are in the
    # tail (problems.suite.auto_with_matvec).
    x = torch.ones(16)
    S = torch.zeros(5, 16, dtype=torch.bfloat16)
    assert tail(x, x, torch.tensor(0.1), x, S, S)[11] is not None
    plain = harness.solve_callables("rosenbrock", 64, cfg.replace(
        use_pallas=False), torch.float64)
    assert plain[2] is None and plain[3] is None and plain[4] is None


def test_bench_gpu_defaults_mirror_bench_tpu():
    import inspect

    from tpu_lbfgs.bench.harness import bench_tpu

    ours = inspect.signature(harness.bench_gpu).parameters
    theirs = inspect.signature(bench_tpu).parameters
    assert list(ours) == list(theirs)
    for name in ("problem", "d", "iters", "cfg", "seeds", "repeats",
                 "with_matvec"):
        assert ours[name].default == theirs[name].default, name
    main = harness.main_path_cfg()
    assert (main.line_search, main.direction, main.ls_eval,
            main.use_pallas) == ("backtracking", "compact_incremental",
                                 "polynomial", True)
