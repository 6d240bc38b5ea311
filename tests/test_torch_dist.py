"""The sharded solve of tpu_lbfgs_torch on 4 CPU processes (gloo) against
the port's single-device solve and against the JAX package's
``sharded_minimize`` on its 8-virtual-device CPU mesh, in float64, step for
step.

One spawn of 4 ranks runs every case (``dist.launch.spawn_ranks`` with
``solve_cases``; a spawn costs some seconds, a case a fraction of one), a
module-scoped fixture holds the ranks' results, and each test reads its
case.  Each rank runs one intra-op thread, and the group has a timeout, so
a rank that dies ends the job instead of hanging it.

Tolerances.  The three solves add the same float64 terms in different
orders (4 shards, 8 shards, one pass), so alpha, status, the counters and
the guard counters are compared for equality over 40 Rosenbrock iterations
from x0 ~ U(-2, 2), d = 203 (uneven: 4 ranks pad it to 204, JAX's mesh to
1024), and f, ||g|| to RTOL = 1e-10 relative over the first TIGHT = 25 of
them and to LATE_RTOL = 1e-7 over the rest: a Rosenbrock trajectory
amplifies the last bits, and the deviation was 2e-13 after 25 iterations
and 2e-9 after 40.  The interpolating searches compute alpha from f's last
bits, so their alphas are held to ALPHA_RTOL (LATE_RTOL past iteration 25)
instead of equality.

The ranks import this module to find their functions, so it imports JAX and
the JAX package only inside the tests that compare with them.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import dist as tdist
from tpu_lbfgs_torch import interop
from tpu_lbfgs_torch.dist.launch import free_port, solve_cases, spawn_ranks

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
RANKS = 4
D = 203
ITERS = 40
TIGHT = 25
RTOL = 1e-10
LATE_RTOL = 1e-7
ALPHA_RTOL = 1e-9
DIRECTIONS = ["two_loop", "compact", "compact_incremental"]
SEARCHES = [("backtracking", "polynomial"), ("wolfe_interpolation", "direct"),
            ("backtracking_speculative", "direct"),
            ("wolfe_interpolation_speculative", "direct")]
INTERPOLATING = ("wolfe_interpolation", "wolfe_interpolation_speculative")


def _case(name, problem="rosenbrock", d=D, dtype="float64", kernels=None,
          kw=None, iters=ITERS, **cfg):
    cfg = dict(dict(max_iters=iters, tol=0.0, record_trace=True), **cfg)
    return dict(name=name, problem=problem, d=d, dtype=dtype, seed=0,
                cfg=cfg, kernels=kernels, kw=kw or {})


def _cases():
    cases = [_case(f"{direction}-{search}", direction=direction,
                   line_search=search, ls_eval=ev)
             for direction in DIRECTIONS for search, ev in SEARCHES]
    poly = dict(line_search="backtracking", ls_eval="polynomial")
    inc = dict(direction="compact_incremental")
    cases += [
        _case("damping-accurate-poly", damping=0.2, accurate_dots=True, **inc,
              **poly),
        _case("damping-accurate-wolfe", damping=0.2, accurate_dots=True,
              direction="compact_incremental",
              line_search="backtracking_wolfe", ls_eval="direct"),
        _case("refresh", refresh_interval=7, **inc, **poly),
        _case("bf16-history", history_dtype="bfloat16", **inc, **poly),
        _case("even-d", d=200, **inc, **poly),
        _case("coupled-poly", problem="coupled_quadratic", iters=8, **inc,
              **poly),
        _case("coupled-wolfe", problem="coupled_quadratic", iters=8,
              direction="two_loop", line_search="backtracking_wolfe",
              ls_eval="direct"),
        # These two reach their minimum in a step or two; a tolerance stops
        # them there, before the iterations that only move rounding noise.
        _case("quadratic-poly", problem="quadratic", iters=3, tol=1e-6, **inc,
              **poly),
        _case("sphere-poly", problem="sphere", iters=3, tol=1e-6,
              direction="compact", **poly),
    ]
    # The kernel path (pallas_sharded) through the kernels' plain
    # shard-local versions, in float64 through solve_shard.
    cases += [_case(f"kernels-{direction}", kernels=True, direction=direction,
                    **poly) for direction in DIRECTIONS]
    cases += [
        _case("kernels-spec-armijo", kernels=True, **inc,
              line_search="backtracking_speculative", ls_eval="direct"),
        _case("kernels-spec-wolfe", kernels=True, **inc,
              line_search="wolfe_interpolation_speculative",
              ls_eval="direct"),
        _case("kernels-matvec", kernels=True, kw=dict(with_matvec=True), m=5,
              **inc, **poly),
        _case("kernels-damping-accurate", kernels=True, damping=0.2,
              accurate_dots=True, **inc, **poly),
        _case("kernels-quadratic", kernels=True, problem="quadratic", iters=3,
              tol=1e-6, **inc, **poly),
        # ... and through sharded_minimize, which takes that path for a
        # float32 x0 under use_pallas, and warns and falls back otherwise.
        _case("f32-pallas", dtype="float32", use_pallas=True, iters=10, **inc,
              **poly),
        _case("f64-pallas-falls-back", use_pallas=True, iters=10, **inc,
              **poly),
        _case("sphere-pallas-falls-back", problem="sphere", dtype="float32",
              use_pallas=True, iters=3, **inc, **poly),
    ]
    return cases


CASES = _cases()
NAMES = [c["name"] for c in CASES]
BY_NAME = {c["name"]: c for c in CASES}


def _extras(rank, size):
    """Rank-side checks that need the group: the comm's primitives, the
    state's gather and scatter, the refusal of a caller's own objective."""
    mesh = tdist.make_mesh()
    comm = mesh.comm
    v = torch.arange(5, dtype=torch.float64) + 10.0 * rank
    w = -v
    (pv, nv), (pw, nw) = comm.edge_pair(v, w)
    total = comm.reduce_parts([torch.tensor(float(rank + 1)),
                               torch.full((2, 2), 0.5 + rank)],
                              torch.float64)
    flag = comm.any_flag(torch.tensor(rank == 2))
    counts = (comm.all_reduces, comm.edge_exchanges)
    p = tt.get_problem("rosenbrock")
    x0 = torch.from_numpy(np.random.default_rng(1).uniform(-2, 2, 37))
    # A caller's own f and grad, no problem name: partitioned by DTensor.
    own = tdist.sharded_minimize(p.f, x0, tt.LBFGSConfig(max_iters=2), mesh,
                                 grad=p.grad)
    own_x = tdist.gather_result(own, mesh, 37).x.numpy()
    # A whole state, sharded and gathered again, and solved on from its
    # shard: equal to the whole-vector solve from the same state.
    cfg = tt.LBFGSConfig(max_iters=6, tol=0.0, direction="compact")
    whole = tt.solve_from_state(cfg, p.f, p.value_and_grad, tt.init_state(
        p.value_and_grad, x0.clone(), cfg.m))
    shard = interop.shard_state(whole, mesh)
    back = interop.gather_state(shard, mesh, 37)
    same = all(torch.equal(getattr(back, f.name), getattr(whole, f.name))
               for f in dataclasses.fields(tt.LBFGSState))
    return dict(edges=(pv.item(), nv.item(), pw.item(), nw.item()),
                total=(total[0].item(), total[1].tolist()),
                flag=bool(flag), own_x=own_x, roundtrip=same,
                shard_shape=tuple(shard.s_hist.shape),
                counts=counts,
                twice=_initialize_twice())


def _initialize_twice():
    import torch.distributed as torch_dist

    before = torch_dist.get_rank()
    tdist.initialize("localhost:1", 99, 5)     # already up: nothing happens
    return torch_dist.get_rank() == before and tdist.process_count() == RANKS


def _rank(rank, size, cases):
    return dict(cases=solve_cases(rank, size, cases, "cpu"),
                extras=_extras(rank, size))


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_rank, RANKS, CASES, backend="gloo", timeout_s=120.0,
                       threads=1)


def _x0(case):
    rng = np.random.default_rng(case["seed"])
    return rng.uniform(-2.0, 2.0, case["d"])


def _single(case):
    """The port's single-device solve of a case, on the CPU."""
    p = tt.get_problem(case["problem"])
    cfg = tt.LBFGSConfig(**case["cfg"])
    dtype = getattr(torch, case["dtype"])
    x0 = torch.from_numpy(_x0(case)).to(dtype)
    poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
    fused = case["kernels"] or (cfg.use_pallas and dtype == torch.float32
                                and case["problem"] != "sphere")
    if not fused:
        return tt.minimize(p.f, x0, cfg.replace(use_pallas=False),
                           grad=p.grad, dir_poly=poly)
    name = case["problem"]
    return tt.minimize(
        p.f, x0, cfg.replace(use_pallas=False),
        value_and_grad=tt.fused_value_and_grad(name), dir_poly=poly,
        fused_tail=tt.fused_tail_for(
            name, with_matvec=case["kw"].get("with_matvec", False),
            accurate_dots=cfg.accurate_dots),
        phi_batch=tt.multi_phi_for(name), phi_dphi_batch=tt.multi_phi_dphi_for(name))


def _compare(got, want_trace, want, cfg, rtol=RTOL, exact_alpha=None):
    """A rank's case result against another solve's trace and result."""
    t = got["trace"]
    if exact_alpha is None:
        exact_alpha = cfg["line_search"] not in INTERPOLATING
    def close(name, early, late):
        a, b = t[name], want_trace[name]
        atol = 1e-14 * float(np.abs(b).max())
        np.testing.assert_allclose(a[:TIGHT], b[:TIGHT], rtol=early,
                                   atol=atol, err_msg=name)
        np.testing.assert_allclose(a[TIGHT:], b[TIGHT:], rtol=late,
                                   atol=atol, err_msg=name + ", late")

    if exact_alpha:
        np.testing.assert_array_equal(t["alpha"], want_trace["alpha"])
    else:
        close("alpha", ALPHA_RTOL, max(LATE_RTOL, rtol))
    for name in ("n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(t[name], want_trace[name], err_msg=name)
    close("f", rtol, max(LATE_RTOL, rtol))
    close("g_norm", rtol, max(LATE_RTOL, rtol))
    assert got["status"] == int(want.status)
    assert got["iterations"] == int(want.iterations)
    assert got["n_fev"] == int(want.n_fev)
    assert got["n_gev"] == int(want.n_gev)
    assert got["guards"] == np.asarray(want.guards).tolist()


def _np_trace(trace):
    return {name: np.asarray(getattr(trace, name)) for name in
            ("f", "g_norm", "alpha", "n_fev", "n_gev", "guards")}


F64 = [n for n in NAMES if BY_NAME[n]["dtype"] == "float64"]


@pytest.mark.parametrize("name", F64)
def test_sharded_equals_the_single_device_port(ranks, name):
    """f64, 4 ranks: every iteration's alpha (equal; the interpolating
    searches to 1e-9), n_fev, n_gev, guards (equal), f and ||g|| (1e-10
    relative), the status and the gathered x."""
    case = BY_NAME[name]
    i = NAMES.index(name)
    got = ranks[0]["cases"][i]
    single = _single(case)
    trace = {k: v.numpy() for k, v in single.trace._asdict().items()}
    _compare(got, trace, single, case["cfg"])
    np.testing.assert_allclose(got["x"], single.x.numpy(), rtol=1e-8,
                               atol=1e-9)
    # Replicated scalars: every rank holds the same bits.
    for other in ranks[1:]:
        o = other["cases"][i]
        assert o["f"] == got["f"] and o["status"] == got["status"]
        np.testing.assert_array_equal(o["trace"]["alpha"],
                                      got["trace"]["alpha"])
        np.testing.assert_array_equal(o["trace"]["f"], got["trace"]["f"])
        assert o["x_local_shape"] == (-(-case["d"] // RANKS),)


JAX_CASES = [n for n in F64 if BY_NAME[n]["kernels"] is None
             and "falls-back" not in n and "bf16" not in n]


@pytest.mark.parametrize("name", JAX_CASES)
def test_sharded_equals_jax_sharded_minimize(ranks, name):
    """The same solve through ``tpu_lbfgs.dist.sharded_minimize`` on the
    8-virtual-device mesh (auto-partitioned jnp path), with the tolerances
    of the module docstring."""
    import jax.numpy as jnp

    import tpu_lbfgs as tl
    from tpu_lbfgs.dist import make_mesh as jax_make_mesh
    from tpu_lbfgs.dist import sharded_minimize as jax_sharded_minimize

    case = BY_NAME[name]
    got = ranks[0]["cases"][NAMES.index(name)]
    p = tl.get_problem(case["problem"])
    cfg = tl.LBFGSConfig(**case["cfg"])
    poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
    res = jax_sharded_minimize(p.f, jnp.asarray(_x0(case)), cfg,
                               mesh=jax_make_mesh(), grad=p.grad,
                               dir_poly=poly, problem=case["problem"])
    _compare(got, _np_trace(res.trace), res, case["cfg"])
    np.testing.assert_allclose(got["x"], np.asarray(res.x), rtol=1e-8,
                               atol=1e-9)


def test_f32_kernel_path_follows_the_single_device_port(ranks):
    """``use_pallas=True`` with a float32 x0 takes the shard-local kernel
    path (on the CPU: the kernels' plain versions) without a warning.  Both
    sides round every sum once to float32 from float64 partials, but the
    single-device solver sums dir_poly and the history products in float32,
    so f is held to 1e-4 over 10 iterations and alpha to equality."""
    got = ranks[0]["cases"][NAMES.index("f32-pallas")]
    assert got["warnings"] == [] and got["launches"] == {}
    single = _single(BY_NAME["f32-pallas"])
    np.testing.assert_array_equal(got["trace"]["alpha"],
                                  single.trace.alpha.numpy())
    np.testing.assert_allclose(got["trace"]["f"], single.trace.f.numpy(),
                               rtol=1e-4)
    assert got["trace"]["f"].dtype == np.float32


@pytest.mark.parametrize("name", ["f64-pallas-falls-back",
                                  "sphere-pallas-falls-back"])
def test_use_pallas_without_shard_kernels_warns_and_falls_back(ranks, name):
    """The reference's rule (dist/sharded.py:147-156): no shard-composable
    kernels for a non-f32 x0 or a problem without a kernel body; the solve
    warns once and runs the plain shard-local path."""
    got = ranks[0]["cases"][NAMES.index(name)]
    assert len(got["warnings"]) == 1
    assert "no shard-composable" in got["warnings"][0]
    assert got["iterations"] == BY_NAME[name]["cfg"]["max_iters"]
    assert np.isfinite(got["f"])


@pytest.mark.parametrize("name,edges", [
    ("quadratic-poly", False), ("kernels-quadratic", False),
    ("sphere-poly", False), ("compact_incremental-backtracking", True),
    ("kernels-compact_incremental", True), ("coupled-poly", True)])
def test_only_chain_problems_exchange_edges(ranks, name, edges):
    """The halo-free problems skip the edge exchange
    (tests/test_dist_pallas.py::test_halo_free_problem_skips_ppermutes)."""
    got = ranks[0]["cases"][NAMES.index(name)]
    assert (got["edge_exchanges"] > 0) is edges
    assert got["all_reduces"] > 0


@pytest.mark.parametrize("name,per_iteration", [
    # vg, dir_poly, the finiteness flag, the tail's sums, the products
    ("compact_incremental-backtracking", 5),
    # the fused tail holds vg's f
    ("kernels-compact_incremental", 4),
    # ... and t1, t2
    ("kernels-matvec", 3),
    # compact: ONE packed (2m, m + 1) block for the four history products
    ("compact-backtracking", 5),
])
def test_all_reduces_per_iteration(ranks, name, per_iteration):
    got = ranks[0]["cases"][NAMES.index(name)]
    k = got["iterations"]
    # + the two of init_state (f, ||g||)
    assert got["all_reduces"] == per_iteration * k + 2


def test_comm_primitives_and_state_interop(ranks):
    for rank, out in enumerate(ranks):
        e = out["extras"]
        prev, nxt = (rank - 1) % RANKS, (rank + 1) % RANKS
        assert e["edges"] == (10.0 * prev + 4, 10.0 * nxt, -(10.0 * prev + 4),
                              -10.0 * nxt)
        assert e["total"] == (10.0, [[8.0, 8.0], [8.0, 8.0]])
        assert e["flag"] is True
        assert e["roundtrip"] is True
        assert e["shard_shape"] == (10, 10)      # 37 -> 40 over 4 ranks
        assert e["counts"] == (2, 1)             # before the solves below
        assert e["twice"] is True


def test_a_callers_own_objective_is_refused_on_several_shards(ranks):
    """No longer refused: a caller's own f and grad on 4 ranks, no problem
    name, equal the single-device solve (tests/test_torch_dist_own.py holds
    the objective to JAX's)."""
    p = tt.get_problem("rosenbrock")
    x0 = torch.from_numpy(np.random.default_rng(1).uniform(-2, 2, 37))
    single = tt.minimize(p.f, x0, tt.LBFGSConfig(max_iters=2), grad=p.grad)
    for out in ranks:
        np.testing.assert_allclose(out["extras"]["own_x"], single.x.numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_one_process_is_a_mesh_of_one_shard():
    """Without a process group ``sharded_minimize`` is ``minimize``, with
    the caller's own callables."""
    mesh = tdist.make_mesh()
    assert (mesh.size, mesh.rank, mesh.comm) == (1, 0, None)
    assert tdist.is_coordinator() and tdist.process_count() == 1
    tdist.initialize()          # no launcher environment: a no-op
    assert not torch.distributed.is_initialized()
    p = tt.get_problem("rosenbrock")
    x0 = torch.from_numpy(_x0(BY_NAME["even-d"]))
    cfg = tt.LBFGSConfig(max_iters=15, tol=0.0, record_trace=True)
    a = tdist.sharded_minimize(p.f, x0, cfg, mesh, grad=p.grad)
    b = tt.minimize(p.f, x0, cfg, grad=p.grad)
    assert torch.equal(a.trace.f, b.trace.f) and torch.equal(a.x, b.x)
    assert tdist.gather_result(a, mesh, 200) is a
    assert tdist.shard_alignment(4) == 4
    x_pad, n = tdist.pad_for_mesh(torch.ones(9), 4)
    assert (tuple(x_pad.shape), n, x_pad[9:].tolist()) == ((12,), 9, [0.0] * 3)
    assert tdist.Mesh(None, 4, 2).bounds(12) == (6, 9)


def _bad_address_rank(port):
    """A lone process told it is rank 1 of 2 at a port nobody serves."""
    tdist.initialize(f"localhost:{port}", 2, 1, backend="gloo", timeout_s=3.0)


def test_initialize_with_explicit_arguments_propagates_failure():
    """An explicit coordinator that nobody answers raises (the reference's
    tests/test_multihost.py::test_initialize_propagates_real_errors); in a
    child process, so a half-made group cannot leak into this one."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from tpu_lbfgs_torch.dist import initialize\n"
            "try:\n"
            "    initialize('localhost:%d', 2, 1, backend='gloo',"
            " timeout_s=3.0)\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__)\n"
            "else:\n"
            "    print('NO ERROR')\n") % (str(REPO), free_port())
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert "RAISED" in proc.stdout, proc.stdout + proc.stderr[-2000:]
    with pytest.raises(ValueError, match="together"):
        tdist.initialize("localhost:1")


def test_a_failing_rank_fails_the_job():
    """The job fails with the error of the rank whose own code raised
    (rank 1), not rank 0's broken collective, whichever exit the parent
    sees first."""
    with pytest.raises(RuntimeError,
                       match="rank 1 failed first: RuntimeError: rank 1 "
                             "gives up"):
        spawn_ranks(_one_rank_raises, 2, timeout_s=20.0)


def test_first_error_is_the_earliest_rank(tmp_path):
    """``first_error`` picks the rank that raised first by its own clock,
    whatever the file order: here rank 2's error, written last."""
    import pickle

    from tpu_lbfgs_torch.dist.launch import first_error

    assert first_error(str(tmp_path)) is None
    for rank, t, msg in ((0, 105.0, "connection closed by peer"),
                         (3, 104.5, "connection closed by peer"),
                         (2, 100.0, "ValueError: the real fault")):
        with open(tmp_path / f"rank{rank}.err", "wb") as fh:
            pickle.dump({"rank": rank, "time": t, "error": msg,
                         "traceback": ""}, fh)
    first = first_error(str(tmp_path))
    assert first["rank"] == 2 and first["error"] == "ValueError: the real fault"


def _one_rank_raises(rank, size):
    if rank == 1:
        raise RuntimeError("rank 1 gives up")
    # Rank 0 waits in a collective; the job ends when its peer is gone.
    tdist.make_mesh().comm.all_reduce_sum(torch.zeros(1, dtype=torch.float64))
    return rank


class _AbortsWhenPickled:
    """A return value whose pickling aborts the process (without a core
    file): a rank that ends by a signal after its ``fn`` returned."""

    def __reduce__(self):
        import resource

        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        os.abort()


def _aborts_after_fn(rank, size):
    return _AbortsWhenPickled() if rank == 1 else rank


def test_a_rank_that_aborts_is_named_with_its_signal_and_mark():
    """A rank that dies by a signal writes no error of its own; the job
    still fails, and its error names the rank, the signal and the last
    point the rank marked."""
    with pytest.raises(RuntimeError,
                       match="rank 1 terminated with signal SIGABRT; its "
                             "last mark: after fn"):
        spawn_ranks(_aborts_after_fn, 2, timeout_s=20.0)


def _job_sum(rank, size, tag):
    t = torch.tensor([100.0 * tag + rank], dtype=torch.float64)
    torch.distributed.all_reduce(t)
    return t.item()


def test_two_jobs_at_once_keep_their_own_groups():
    """Two jobs spawned at the same time on one host each join their own
    ranks: each sums its own tags."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(spawn_ranks, _job_sum, 2, tag, backend="gloo",
                            timeout_s=60.0) for tag in (1, 2)]
        assert [job.result() for job in jobs] == [[201.0] * 2, [401.0] * 2]


def test_a_port_taken_by_another_job_does_not_matter(monkeypatch):
    """The job's ranks rendezvous in its own directory: a port that
    another process holds, even the one ``free_port`` would hand out,
    leaves the job unharmed."""
    import socket

    from tpu_lbfgs_torch.dist import launch

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as held:
        held.bind(("localhost", 0))
        held.listen()
        monkeypatch.setattr(launch, "free_port",
                            lambda: held.getsockname()[1])
        assert spawn_ranks(_job_sum, 2, 1, backend="gloo",
                           timeout_s=30.0) == [201.0, 201.0]


def test_cli_shard_matches_the_reference_cli():
    """``torchrun --nproc-per-node=4 -m tpu_lbfgs_torch ... --shard`` against
    ``python -m tpu_lbfgs --shard`` (in process, on the 8-device mesh) and
    against the port's unsharded command line, in f64: status, iterations
    and counters equal, f and ||g|| to 1e-10.  ``--standalone``: torchrun
    binds its rendezvous port itself, so a job started at the same time
    cannot take it first."""
    import contextlib
    import io

    from tpu_lbfgs import cli as jax_cli
    from tpu_lbfgs_torch import cli as torch_cli

    argv = ("--problem rosenbrock --dim 203 --dtype float64 --max-iters 25 "
            "--line-search wolfe_interpolation --direction compact "
            "--json").split()
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run",
         f"--nproc-per-node={RANKS}", "--standalone",
         "-m", "tpu_lbfgs_torch", "--device", "cpu", "--shard"] + argv,
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    docs = [line for line in proc.stdout.splitlines()
            if line.startswith('{"config"')]
    assert len(docs) == 1           # rank 0 alone prints the record
    ours = json.loads(docs[0])["results"][0]

    def in_process(main, args):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert main(args) == 0
        return json.loads(out.getvalue().strip().splitlines()[-1])[
            "results"][0]

    for other in (in_process(jax_cli.main, argv + ["--shard"]),
                  in_process(torch_cli.main, argv + ["--device", "cpu"]),
                  in_process(torch_cli.main,
                             argv + ["--device", "cpu", "--shard"])):
        for key in ("status", "iterations", "n_fev", "n_gev", "guards"):
            assert ours[key] == other[key], key
        assert ours["f"] == pytest.approx(other["f"], rel=RTOL)
        assert ours["g_norm"] == pytest.approx(other["g_norm"], rel=RTOL)
