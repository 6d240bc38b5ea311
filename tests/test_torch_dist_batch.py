"""The batched, sharded solve of tpu_lbfgs_torch (``sharded_vmap_minimize``)
on 4 CPU processes (gloo) laid out as a 2 x 2 (b, d) mesh, against the JAX
package's ``sharded_vmap_minimize`` on 4 of its 8 virtual CPU devices
(``make_mesh_2d(batch_size=2)``), against the port's single-device
``vmap_minimize``, and lane by lane against the port's one-instance sharded
solve on a d group of 2; then the batched plain versions of the shard-local
kernels row by row, in process.

One spawn of 4 ranks runs every case (``dist.launch.spawn_ranks`` with
``solve_cases``, as tests/test_torch_dist.py), a module-scoped fixture holds
the ranks' results, and each test reads its case.  B = 4 instances: rows of
2 lanes, each lane's vector in 2 shards.

Tolerances are tests/test_torch_dist.py's: alpha, status, the counters and
the guard counters equal at every iteration of the trace (the interpolating
searches' alphas to ALPHA_RTOL), f and ||g|| to RTOL = 1e-10 over the first
TIGHT = 25 iterations and LATE_RTOL = 1e-7 after.  A bounded solve keeps no
trace, so its final fields are held to the same bounds.  The float32 kernel
path is held to JAX's interpreted Pallas path with the tolerances of
tests/test_dist_pallas.py::test_sharded_vmap_minimize_pallas_path_equivalence.

The ranks import this module to find their functions, so it imports JAX and
the JAX package only inside the tests that compare with them.
"""
import numpy as np
import pytest
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import dist as tdist
from tpu_lbfgs_torch.dist.launch import solve_cases, spawn_ranks

torch.set_num_threads(1)

RANKS = 4
ROWS = 2
B = 4
D = 256
RAGGED = D + 5
ITERS = 40
TIGHT = 25
RTOL = 1e-10
LATE_RTOL = 1e-7
ALPHA_RTOL = 1e-9
SPEC_ITERS = 20
PALLAS_D = 2048          # the reference's shard alignment on 2 d shards
PALLAS_ITERS = 20
INTERPOLATING = ("wolfe_interpolation", "wolfe_interpolation_speculative")
POLY = dict(direction="compact_incremental", line_search="backtracking",
            ls_eval="polynomial")
FIELDS = ("f", "g_norm", "status", "iterations", "n_fev", "n_gev", "guards")


def _case(name, problem="rosenbrock", d=D, dtype="float64",
          lockstep="while", kernels=None, kw=None, iters=ITERS, rows=ROWS,
          **cfg):
    cfg = dict(dict(POLY, max_iters=iters, tol=0.0,
                    record_trace=lockstep == "while"), **cfg)
    return dict(name=name, problem=problem, d=d, dtype=dtype, seed=0,
                batch=B, batch_size=rows, lockstep=lockstep, cfg=cfg,
                kernels=kernels, kw=kw or {})


# (problem, iterations, config) of the plain path's cases.
PLAIN = [("rosenbrock", ITERS, {}), ("coupled_quadratic", 8, {}),
         # reaches its minimum, g = 0 exactly, in two steps; a bounded solve
         # would iterate on from there through rounding noise
         ("quadratic", 2, dict(tol=1e-6))]
SEARCHES = ["backtracking_speculative", "wolfe_interpolation_speculative",
            "backtracking_wolfe_speculative"]


def _cases():
    cases = [_case(f"plain-{problem}-{lockstep}-{d}", problem, d,
                   lockstep=lockstep, iters=iters, **cfg)
             for problem, iters, cfg in PLAIN
             for lockstep in ("while", "bounded") for d in (D, RAGGED)]
    # The kernel path (pallas_sharded) through the batched plain versions
    # of the shard-local kernels, in float64 through solve_shard.
    cases += [_case(f"kernels-{lockstep}", d=RAGGED, kernels=True,
                    lockstep=lockstep) for lockstep in ("while", "bounded")]
    cases += [_case(f"kernels-{search}", d=RAGGED, kernels=True,
                    iters=SPEC_ITERS, line_search=search, ls_eval="direct")
              for search in SEARCHES]
    cases += [
        _case("kernels-matvec-bf16", kernels=True, iters=SPEC_ITERS, m=5,
              history_dtype="bfloat16", kw=dict(with_matvec=True)),
        _case("kernels-coupled", "coupled_quadratic", RAGGED, kernels=True,
              iters=8),
        _case("kernels-quadratic", "quadratic", kernels=True, iters=3,
              tol=1e-6),
        # ... and through sharded_vmap_minimize, which takes that path for
        # a float32 batch under use_pallas, and warns and falls back
        # otherwise.
        _case("f32-pallas", d=PALLAS_D, dtype="float32", iters=PALLAS_ITERS,
              use_pallas=True),
        _case("f32-pallas-spec", d=PALLAS_D, dtype="float32",
              iters=PALLAS_ITERS, use_pallas=True,
              line_search="backtracking_speculative", ls_eval="direct"),
        _case("f64-pallas-falls-back", iters=10, use_pallas=True),
        _case("sphere-pallas-falls-back", "sphere", dtype="float32",
              iters=3, use_pallas=True),
        # A 4 x 1 mesh: one lane a row, no d group.
        _case("b-by-1", rows=RANKS, iters=20),
    ]
    return cases


CASES = _cases()
NAMES = [c["name"] for c in CASES]
BY_NAME = {c["name"]: c for c in CASES}
# The kernel cases whose lanes also run one at a time through the
# one-instance sharded solve on the rows' d groups.
PER_LANE = [n for n in NAMES if BY_NAME[n]["kernels"]]


def _x0(case):
    rng = np.random.default_rng(case["seed"])
    return rng.uniform(-2.0, 2.0, (case["batch"], case["d"]))


def _per_lane(mesh, case):
    """Each of this row's lanes alone through the one-instance shard-local
    solve (``solve_shard`` with a (d_local,) block) on the row's d group:
    per lane a dict of the result's fields, its trace and its whole x."""
    from tpu_lbfgs_torch.dist.mesh import local_block, local_lanes
    from tpu_lbfgs_torch.dist.sharded import solve_shard

    cfg = tt.LBFGSConfig(**case["cfg"])
    x0 = torch.from_numpy(_x0(case)).to(getattr(torch, case["dtype"]))
    outs = []
    for lane in local_lanes(x0, mesh):
        x_pad, n = tdist.pad_for_mesh(lane, mesh.size)
        res = solve_shard(case["problem"], local_block(x_pad, mesh), n, cfg,
                          mesh, kernels=True,
                          bounded=case["lockstep"] == "bounded",
                          **case["kw"])
        whole = tdist.gather_result(res, mesh, case["d"])
        out = {name: getattr(res, name).numpy() for name in FIELDS}
        out["x"] = whole.x.numpy()
        if res.trace is not None:
            out["trace"] = {k: v.numpy() for k, v in
                            res.trace._asdict().items()}
        outs.append(out)
    return outs


def _extras(rank, size):
    """Rank-side checks that need the group: the 2-D mesh's layout and its
    refusal, the lane-aware edge exchange, the reference's ValueErrors and
    the refusal of a caller's own objective."""
    import torch.distributed as torch_dist

    mesh = tdist.make_mesh_2d(ROWS)
    v = torch.arange(6, dtype=torch.float64).reshape(2, 3) + 10.0 * rank
    ((prev, nxt),) = mesh.comm.edge_pair(v)
    try:
        tdist.make_mesh_2d(3)
        bad_rows = ""
    except ValueError as e:
        bad_rows = str(e)
    p = tt.get_problem("rosenbrock")
    x0 = torch.from_numpy(np.random.default_rng(1).uniform(-2, 2, (4, 37)))
    cfg = tt.LBFGSConfig(max_iters=2)
    refusals = {}
    for key, call in {
            "no-mesh": lambda: tdist.sharded_vmap_minimize(
                p.f, x0, cfg, None, grad=p.grad, problem="rosenbrock"),
            "lockstep": lambda: tdist.sharded_vmap_minimize(
                p.f, x0, cfg, mesh, grad=p.grad, problem="rosenbrock",
                lockstep="never"),
            "bounded-trace": lambda: tdist.sharded_vmap_minimize(
                p.f, x0, cfg.replace(record_trace=True), mesh, grad=p.grad,
                problem="rosenbrock", lockstep="bounded"),
            "rows": lambda: tdist.sharded_vmap_minimize(
                p.f, x0[:3], cfg, mesh, grad=p.grad, problem="rosenbrock"),
            "own-objective": lambda: tdist.sharded_vmap_minimize(
                p.f, x0, cfg, mesh, grad=p.grad)}.items():
        try:
            res = call()
            refusals[key] = f"taken: {tuple(res.x.shape)}"
        except (ValueError, NotImplementedError) as e:
            refusals[key] = f"{type(e).__name__}: {e}"
    per_lane = {name: _per_lane(mesh, BY_NAME[name]) for name in PER_LANE}
    return dict(place=(mesh.batch_size, mesh.batch_rank, mesh.size,
                       mesh.rank, mesh.grid.size,
                       torch_dist.get_world_size(mesh.comm.group)),
                edges=(prev.tolist(), nxt.tolist()), bad_rows=bad_rows,
                refusals=refusals, per_lane=per_lane)


def _rank(rank, size, cases):
    return dict(cases=solve_cases(rank, size, cases, "cpu"),
                extras=_extras(rank, size))


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_rank, RANKS, CASES, backend="gloo", timeout_s=120.0,
                       threads=1)


def _got(ranks, name):
    return ranks[0]["cases"][NAMES.index(name)]


def _close(got, want, name, early, late):
    """got and want (B, iterations, ...) traces of one field."""
    atol = 1e-14 * float(np.abs(want).max())
    np.testing.assert_allclose(got[:, :TIGHT], want[:, :TIGHT], rtol=early,
                               atol=atol, err_msg=name)
    np.testing.assert_allclose(got[:, TIGHT:], want[:, TIGHT:], rtol=late,
                               atol=atol, err_msg=name + ", late")


def _start_scales(case):
    """max over the lanes of f and ||g|| at x0: the absolute floor of the
    final fields' comparison, as the trace's first row is for the trace (a
    quadratic's f falls by 18 orders of magnitude in 8 iterations)."""
    p = tt.get_problem(case["problem"])
    x0 = torch.from_numpy(_x0(case))
    return (float(p.f(x0).abs().max()),
            float(torch.linalg.vector_norm(p.grad(x0), dim=-1).max()))


def _compare(got, want, case):
    """A case's gathered result (dict of numpy, fields (B, ...)) against
    another solve's (the same keys): every iteration of the trace where
    there is one, the final fields always."""
    cfg = case["cfg"]
    exact_alpha = cfg["line_search"] not in INTERPOLATING
    if "trace" in got:
        t, w = got["trace"], want["trace"]
        if exact_alpha:
            np.testing.assert_array_equal(t["alpha"], w["alpha"])
        else:
            _close(t["alpha"], w["alpha"], "alpha", ALPHA_RTOL, LATE_RTOL)
        for name in ("n_fev", "n_gev", "guards"):
            np.testing.assert_array_equal(t[name], w[name], err_msg=name)
        _close(t["f"], w["f"], "f", RTOL, LATE_RTOL)
        _close(t["g_norm"], w["g_norm"], "g_norm", RTOL, LATE_RTOL)
    rtol = RTOL if cfg["max_iters"] <= TIGHT else LATE_RTOL
    for name in ("status", "iterations", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    for name, scale in zip(("f", "g_norm"), _start_scales(case)):
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=rtol, atol=1e-14 * scale,
                                   err_msg=name)
    np.testing.assert_allclose(got["x"], np.asarray(want["x"]), rtol=1e-8,
                               atol=1e-9)


def _as_dict(res):
    out = {name: np.asarray(getattr(res, name)) for name in FIELDS}
    out["x"] = np.asarray(res.x)
    if res.trace is not None:
        out["trace"] = {name: np.asarray(getattr(res.trace, name)) for name in
                        ("f", "g_norm", "alpha", "n_fev", "n_gev", "guards")}
    return out


def _single(case):
    """The port's single-device batch solve of a case, on the CPU: for the
    kernel path with the fused value and gradient (their plain versions
    here), the problem's own f and gradient otherwise."""
    p = tt.get_problem(case["problem"])
    cfg = tt.LBFGSConfig(**case["cfg"]).replace(use_pallas=False)
    x0 = torch.from_numpy(_x0(case)).to(getattr(torch, case["dtype"]))
    poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
    vg = tt.fused_value_and_grad(case["problem"]) if case["kernels"] \
        else None
    return tt.vmap_minimize(p.f, x0, cfg, grad=None if vg else p.grad,
                            value_and_grad=vg, dir_poly=poly,
                            lockstep=case["lockstep"])


JAX_CASES = [n for n in NAMES if n.startswith("plain-")]


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_path_equals_jax_sharded_vmap_minimize(ranks, name):
    """f64, the plain shard-local path, 2 x 2 meshes on both sides: every
    lane's alpha, n_fev, n_gev and guards equal at every iteration (or at
    the end under bounded lockstep), f and ||g|| to 1e-10 / 1e-7, the
    statuses, iterations and the gathered (B, d) x."""
    import jax
    import jax.numpy as jnp

    import tpu_lbfgs as tl
    from tpu_lbfgs.dist import make_mesh_2d as jax_make_mesh_2d
    from tpu_lbfgs.dist import sharded_vmap_minimize as jax_svm

    case = BY_NAME[name]
    got = _got(ranks, name)
    p = tl.get_problem(case["problem"])
    cfg = tl.LBFGSConfig(**case["cfg"])
    mesh = jax_make_mesh_2d(batch_size=ROWS, devices=jax.devices()[:RANKS])
    res = jax_svm(p.f, jnp.asarray(_x0(case)), cfg, mesh=mesh, grad=p.grad,
                  dir_poly=p.dir_poly, problem=case["problem"],
                  lockstep=case["lockstep"])
    assert got["x"].shape == (B, case["d"])
    _compare(got, _as_dict(res), case)


@pytest.mark.parametrize("name", JAX_CASES)
def test_plain_path_equals_the_single_device_port(ranks, name):
    """The same cases against the port's ``vmap_minimize`` on one
    process, and every rank holding the same gathered bits."""
    case = BY_NAME[name]
    got = _got(ranks, name)
    _compare(got, _as_dict(_single(case)), case)
    for other in ranks[1:]:
        o = other["cases"][NAMES.index(name)]
        np.testing.assert_array_equal(o["f"], got["f"])
        np.testing.assert_array_equal(o["x"], got["x"])


KERNEL_CASES = [n for n in NAMES if BY_NAME[n]["kernels"]]
# The single-device solve's products over a bfloat16 ring contract the
# rounded row, the tail's the raw y (as the reference's): another
# function, held to the batched fused tail instead below.
VMAP_KERNEL_CASES = [n for n in KERNEL_CASES if "bf16" not in n]


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_path_lanes_equal_the_one_instance_sharded_solve(ranks, name):
    """f64, the kernel path's wrappers on their batched plain versions:
    every lane against the same lane solved alone by the one-instance
    shard-local path on its row's d group of 2."""
    case = BY_NAME[name]
    got = _got(ranks, name)
    lanes = [lane for r in range(0, RANKS, RANKS // ROWS)
             for lane in ranks[r]["extras"]["per_lane"][name]]
    want = {key: np.stack([lane[key] for lane in lanes])
            for key in FIELDS + ("x",)}
    if "trace" in got:
        want["trace"] = {key: np.stack([lane["trace"][key] for lane in lanes])
                         for key in lanes[0]["trace"]}
    _compare(got, want, case)


@pytest.mark.parametrize("name", VMAP_KERNEL_CASES)
def test_kernel_path_equals_vmap_minimize(ranks, name):
    """The same cases against the port's single-device ``vmap_minimize``
    with the fused value and gradient; the K-trial searches take (B, K)
    steps through the batched shard-local evaluators on the mesh and K plain
    passes on one device."""
    case = BY_NAME[name]
    _compare(_got(ranks, name), _as_dict(_single(case)), case)


def test_kernel_path_matvec_on_a_bf16_ring_equals_the_batched_tail(ranks):
    """t1, t2 in the tail on a bfloat16 ring: the single-device batch solve
    with the batched fused tail (``fused_tail_for(with_matvec=True)``), the
    same function, step for step."""
    from tpu_lbfgs_torch.core.solver import solve_to_result

    case = BY_NAME["kernels-matvec-bf16"]
    p = tt.get_problem(case["problem"])
    cfg = tt.LBFGSConfig(**case["cfg"])
    x0 = torch.from_numpy(_x0(case))
    vg = tt.fused_value_and_grad(case["problem"])
    state = tt.init_state(vg, x0, cfg.m, cfg.history_dtype)
    res = solve_to_result(cfg, p.f, vg, state, p.dir_poly,
                          fused_tail=tt.fused_tail_for(case["problem"],
                                                       with_matvec=True))
    _compare(_got(ranks, "kernels-matvec-bf16"), _as_dict(res), case)


@pytest.mark.parametrize("name", ["f32-pallas", "f32-pallas-spec"])
def test_f32_kernel_path_follows_jax_pallas(ranks, name):
    """``use_pallas=True`` with a float32 batch takes the shard-local
    kernel path (on the CPU: the batched plain versions) without a
    warning, against JAX's Pallas ``sharded_vmap_minimize`` (interpreted on
    the CPU): iterations equal, f to 5e-4, x to 1e-3."""
    import warnings

    import jax
    import jax.numpy as jnp

    import tpu_lbfgs as tl
    from tpu_lbfgs.dist import make_mesh_2d as jax_make_mesh_2d
    from tpu_lbfgs.dist import sharded_vmap_minimize as jax_svm

    case = BY_NAME[name]
    got = _got(ranks, name)
    assert got["warnings"] == [] and got["launches"] == {}
    assert got["f"].dtype == np.float32
    p = tl.get_problem(case["problem"])
    cfg = tl.LBFGSConfig(**case["cfg"])
    mesh = jax_make_mesh_2d(batch_size=ROWS, devices=jax.devices()[:RANKS])
    poly = p.dir_poly if cfg.ls_eval == "polynomial" else None
    with warnings.catch_warnings():
        warnings.simplefilter("error")      # the Pallas path must not warn
        res = jax_svm(p.f, jnp.asarray(_x0(case), jnp.float32), cfg,
                      mesh=mesh, grad=p.grad, dir_poly=poly,
                      problem=case["problem"])
    np.testing.assert_array_equal(got["iterations"],
                                  np.asarray(res.iterations))
    np.testing.assert_allclose(got["f"], np.asarray(res.f), rtol=5e-4)
    np.testing.assert_allclose(got["x"], np.asarray(res.x), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("name", ["f64-pallas-falls-back",
                                  "sphere-pallas-falls-back"])
def test_use_pallas_without_shard_kernels_warns_and_falls_back(ranks, name):
    """The reference's rule (tpu_lbfgs/dist/sharded.py:296-304): no
    shard-composable kernels for a float64 batch or a problem without a
    kernel body; the solve warns once and runs the plain shard-local
    path."""
    got = _got(ranks, name)
    assert len(got["warnings"]) == 1
    assert "sharded_vmap_minimize: use_pallas=True has no shard-composable" \
        in got["warnings"][0]
    np.testing.assert_array_equal(got["iterations"],
                                  BY_NAME[name]["cfg"]["max_iters"])
    assert np.isfinite(got["f"]).all()


def test_a_b_by_1_mesh_solves_its_lanes_with_vmap_minimize(ranks):
    """Four rows of one rank: no d group (no collective during the solve),
    each row's lane through ``vmap_minimize`` with the caller's callables,
    gathered over the rows."""
    case = BY_NAME["b-by-1"]
    got = _got(ranks, "b-by-1")
    assert got["all_reduces"] == got["edge_exchanges"] == 0
    assert got["x_local_shape"] == (1, case["d"])
    _compare(got, _as_dict(_single(case)), case)


@pytest.mark.parametrize("name,per_iteration", [
    # dir_poly, the finiteness flag, the tail's sums, the products
    ("kernels-while", 4),
    # ... and vg's f on the plain path
    ("plain-rosenbrock-while-256", 5),
    # t1, t2 come with the tail's sums
    ("kernels-matvec-bf16", 3),
])
def test_one_all_reduce_serves_every_lane(ranks, name, per_iteration):
    """A row's collectives do not grow with its lanes: the counts per
    iteration of tests/test_torch_dist.py's one-instance solves, for two
    lanes."""
    got = _got(ranks, name)
    k = int(got["iterations"].max())
    # + the two of init_state (f, ||g||)
    assert got["all_reduces"] == per_iteration * k + 2
    assert got["edge_exchanges"] == 2 * k + 1


@pytest.mark.parametrize("name,edges", [
    ("plain-quadratic-while-256", False), ("kernels-quadratic", False),
    ("kernels-coupled", True), ("plain-coupled_quadratic-while-261", True)])
def test_only_chain_problems_exchange_edges(ranks, name, edges):
    got = _got(ranks, name)
    assert (got["edge_exchanges"] > 0) is edges
    assert got["all_reduces"] > 0


def test_mesh_2d_layout_and_edge_exchange(ranks):
    """Ranks row-major on (b, d), as the reference's reshape(batch_size,
    n // batch_size); each row's d group of 2; the edge exchange of a
    (2, 3) block gives each lane its neighbours' boundary values; three rows
    do not divide four ranks."""
    for rank, out in enumerate(ranks):
        e = out["extras"]
        row, col = divmod(rank, RANKS // ROWS)
        assert e["place"] == (ROWS, row, RANKS // ROWS, col, RANKS, 2)
        # The group's ranks are row * 2 + (col -+ 1) mod 2.
        other = 10.0 * (row * 2 + (1 - col))
        assert e["edges"] == ([other + 2, other + 5], [other, other + 3])
        assert e["bad_rows"] == "4 devices not divisible by batch axis 3"


@pytest.mark.parametrize("key,kind", [
    ("no-mesh", "ValueError"), ("lockstep", "ValueError"),
    ("bounded-trace", "ValueError"), ("rows", "ValueError"),
    ("own-objective", "taken")])
def test_refusals(ranks, key, kind):
    """The reference's ValueErrors with its messages (a missing mesh, a bad
    lockstep, bounded with a trace) and a batch the rows do not divide; a
    caller's own objective on more than one shard is taken (partitioned
    by DTensor), and each rank holds its row's 2 lanes of its 19 + 19
    columns."""
    for out in ranks:
        assert out["extras"]["refusals"][key].startswith(kind + ": ")
    msg = ranks[0]["extras"]["refusals"][key].split(": ", 1)[1]
    if key in ("no-mesh", "lockstep", "bounded-trace"):
        import jax.numpy as jnp

        import tpu_lbfgs as tl
        from tpu_lbfgs.dist import sharded_vmap_minimize as jax_svm

        p = tl.get_problem("rosenbrock")
        cfg = tl.LBFGSConfig(max_iters=2, record_trace=key == "bounded-trace")
        with pytest.raises(ValueError) as exc:
            jax_svm(p.f, jnp.zeros((4, 37)), cfg,
                    mesh=None if key == "no-mesh" else object(),
                    grad=p.grad,
                    lockstep={"lockstep": "never",
                              "bounded-trace": "bounded"}.get(key, "while"))
        assert str(exc.value) == msg
    elif key == "own-objective":
        assert msg == "(2, 19)"


def test_one_process_mesh_is_vmap_minimize():
    """Without a process group ``make_mesh_2d(1)`` is the one process,
    ``sharded_vmap_minimize`` on it is ``vmap_minimize`` with the caller's
    callables, and two rows do not divide it."""
    mesh = tdist.make_mesh_2d(1)
    assert (mesh.size, mesh.batch_size, mesh.comm, mesh.grid) == \
        (1, 1, None, None)
    with pytest.raises(ValueError, match="not divisible by batch axis 2"):
        tdist.make_mesh_2d(2)
    p = tt.get_problem("rosenbrock")
    x0 = torch.from_numpy(np.random.default_rng(2).uniform(-2, 2, (3, 40)))
    cfg = tt.LBFGSConfig(max_iters=15, tol=0.0, record_trace=True, **POLY)
    a = tdist.sharded_vmap_minimize(p.f, x0, cfg, mesh, grad=p.grad,
                                    dir_poly=p.dir_poly)
    b = tt.vmap_minimize(p.f, x0, cfg, grad=p.grad, dir_poly=p.dir_poly)
    assert torch.equal(a.trace.f, b.trace.f) and torch.equal(a.x, b.x)
    assert tdist.gather_result(a, mesh, 40) is a


# --- the batched plain versions of the shard-local kernels -----------------

def _local_inputs(lanes=3, n=37, m=4, k=5, seed=7):
    """Float64 rows of one shard (start 37 of a global 111, the last shard
    ending in 3 padded elements zeroed as the solver pads them)."""
    rng = np.random.default_rng(seed)

    def t(*shape, lo=-1.0, hi=1.0):
        return torch.from_numpy(rng.uniform(lo, hi, shape))

    x, d, g = t(lanes, n, lo=-2.0, hi=2.0), t(lanes, n), t(lanes, n)
    S, Y = t(lanes, m, n), t(lanes, m, n)
    alpha, alphas = t(lanes, lo=0.01, hi=2.0), t(lanes, k, lo=0.01, hi=2.0)
    edges = t(lanes, 4)
    return dict(x=x, d=d, g=g, S=S, Y=Y, alpha=alpha, alphas=alphas,
                edges=edges, n=3 * n - 3, start=n)


def _plain_calls(problem, inp, form):
    from tpu_lbfgs_torch.dist.shardmap_vg import local_vg_plain
    from tpu_lbfgs_torch.kernels import fused_ops as ops
    from tpu_lbfgs_torch.kernels import line_search_ops as ls

    n, start = inp["n"], inp["start"]
    if form == "vg":
        return lambda i: local_vg_plain(problem, i["x"], n, start,
                                        i["edges"][..., [0, 2]])
    if form.startswith("tail"):
        products, accurate = "products" in form, "accurate" in form
        hist = (lambda i: (i["S"].to(torch.bfloat16), i["Y"].to(
            torch.bfloat16))) if "bf16" in form else \
            (lambda i: (i["S"], i["Y"]))
        return lambda i: ops.fused_tail_local_plain(
            problem, i["x"], i["d"], i["alpha"], i["g"], *hist(i), products,
            n, start, i["edges"], accurate)
    if form == "multi_phi":
        return lambda i: ls.multi_phi_local_plain(
            problem, i["x"], i["d"], i["alphas"], n, start,
            i["edges"][..., 2:])
    return lambda i: ls.multi_phi_dphi_local_plain(
        problem, i["x"], i["d"], i["alphas"], n, start, i["edges"])


PLAIN_FORMS = ["vg", "tail", "tail-products", "tail-products-bf16",
               "tail-accurate", "multi_phi", "multi_phi_dphi"]


@pytest.mark.parametrize("problem", ["quadratic", "rosenbrock",
                                     "coupled_quadratic"])
@pytest.mark.parametrize("form", PLAIN_FORMS)
def test_batched_plain_versions_equal_row_by_row(problem, form):
    """One call of each shard-local plain version on a batch (3 lanes, each
    with its own step, K steps and edges) against the same call on each
    row alone: every output bit for bit, the float64 sums included, and of
    the batched shapes."""
    inp = _local_inputs()
    call = _plain_calls(problem, inp, form)
    batched = call(inp)
    batched = batched if isinstance(batched, tuple) else (batched,)
    for j in range(3):
        row = {k: v if k in ("n", "start") else v[j] for k, v in inp.items()}
        one = call(row)
        one = one if isinstance(one, tuple) else (one,)
        assert len(one) == len(batched)
        for a, b in zip(batched, one):
            assert a.shape[0] == 3 and a.shape[1:] == b.shape
            assert a.dtype == b.dtype and torch.equal(a[j], b), form
