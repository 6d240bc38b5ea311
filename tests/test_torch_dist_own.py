"""A caller's own objective on the sharded solves of tpu_lbfgs_torch
(``sharded_minimize``, and ``sharded_vmap_minimize`` on a 2 x 2 (b, d)
mesh), on 4 CPU processes (gloo), partitioned by DTensor
(``dist.partitioned``), against the JAX package's ``sharded_minimize`` /
``sharded_vmap_minimize`` of the same objective written in jnp (its
auto-partitioned path on 4 of its 8 virtual CPU devices), against the
port's single-device ``minimize`` / ``vmap_minimize`` of the same torch
objective, and against the named suite problem's sharded solve.

One spawn of 4 ranks runs every case (``dist.launch.spawn_ranks``); a
module-scoped fixture holds the results.  Tolerances are
tests/test_torch_dist.py's: alpha, status, the counters and the guard
counters equal at every iteration, f and ||g|| to RTOL = 1e-10 over the
first TIGHT = 25 iterations and LATE_RTOL = 1e-7 after; a bounded batch
keeps no trace and its final fields are held to LATE_RTOL.

The ranks import this module to find their functions, so it imports JAX and
the JAX package only inside the tests that compare with them.
"""
import numpy as np
import pytest
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import dist as tdist
from tpu_lbfgs_torch.dist.launch import spawn_ranks

torch.set_num_threads(1)

RANKS = 4
ROWS = 2
B = 4
D = 256
RAGGED = 261
ITERS = 40
TIGHT = 25
RTOL = 1e-10
LATE_RTOL = 1e-7
FIELDS = ("f", "g_norm", "status", "iterations", "n_fev", "n_gev", "guards")
TRACED = ("f", "g_norm", "alpha", "n_fev", "n_gev", "guards")


def torch_rosenbrock(x):
    """Chained Rosenbrock as a caller writes it, on (d,) or (B, d)."""
    t = x[..., 1:] - x[..., :-1] ** 2
    return torch.sum(100.0 * t * t + (1.0 - x[..., :-1]) ** 2, dim=-1)


def torch_huber(x):
    """A pseudo-Huber objective: elementwise terms and one sum."""
    r = x - 1.0
    return torch.sum(torch.sqrt(1.0 + r * r) - 1.0 + 0.01 * x * x, dim=-1)


def jax_objective(name):
    import jax.numpy as jnp

    if name == "rosenbrock":
        def f(x):
            t = x[1:] - x[:-1] ** 2
            return jnp.sum(100.0 * t * t + (1.0 - x[:-1]) ** 2)
    else:
        def f(x):
            r = x - 1.0
            return jnp.sum(jnp.sqrt(1.0 + r * r) - 1.0 + 0.01 * x * x)
    return f


OBJECTIVES = {"rosenbrock": torch_rosenbrock, "huber": torch_huber}
DIRECT = dict(direction="compact_incremental", line_search="backtracking",
              ls_eval="direct")


def _case(name, objective="rosenbrock", d=D, batch=False,
          lockstep="while", kw=None, iters=ITERS, **cfg):
    cfg = dict(dict(DIRECT, max_iters=iters, tol=0.0,
                    record_trace=lockstep == "while"), **cfg)
    return dict(name=name, objective=objective, d=d, batch=batch,
                lockstep=lockstep, cfg=cfg, kw=kw or {})


CASES = (
    [_case(f"rosenbrock-{d}", d=d) for d in (D, RAGGED)]
    # The pseudo-Huber solve converges within the iterations; past that
    # its line searches are decided by rounding, so it stops at a
    # tolerance.
    + [_case("huber-261", "huber", d=RAGGED, tol=1e-8),
       _case("rosenbrock-two-loop", d=RAGGED, direction="two_loop"),
       _case("rosenbrock-polynomial", d=RAGGED, ls_eval="polynomial",
             kw=dict(dir_poly=True)),
       _case("rosenbrock-grad", d=RAGGED, kw=dict(grad=True))]
    + [_case(f"batch-rosenbrock-{lockstep}-{d}", d=d, batch=True,
             lockstep=lockstep, iters=ITERS if lockstep == "while" else 20)
       for lockstep in ("while", "bounded") for d in (D, RAGGED)]
)
NAMES = [c["name"] for c in CASES]
BY_NAME = {c["name"]: c for c in CASES}


def _x0(case):
    shape = (B, case["d"]) if case["batch"] else case["d"]
    return np.random.default_rng(0).uniform(-2.0, 2.0, shape)


def _result(res, mesh, d):
    whole = tdist.gather_result(res, mesh, d)
    out = {name: getattr(whole, name).numpy() for name in FIELDS}
    out["x"] = whole.x.numpy()
    if whole.trace is not None:
        out["trace"] = {name: getattr(whole.trace, name).numpy()
                        for name in TRACED}
    return out


def _solve(case, meshes):
    cfg = tt.LBFGSConfig(**case["cfg"])
    x0 = torch.from_numpy(_x0(case))
    p = tt.get_problem("rosenbrock")
    kw = {}
    if case["kw"].get("dir_poly"):
        kw["dir_poly"] = p.dir_poly
    if case["kw"].get("grad"):
        kw["grad"] = p.grad
    f = OBJECTIVES[case["objective"]]
    if case["batch"]:
        mesh = meshes["2d"]
        res = tdist.sharded_vmap_minimize(f, x0, cfg, mesh,
                                          lockstep=case["lockstep"], **kw)
    else:
        mesh = meshes["1d"]
        res = tdist.sharded_minimize(f, x0, cfg, mesh, **kw)
    return _result(res, mesh, case["d"])


def _registry():
    """The native functional collectives not yet waited for (PyTorch's
    registry of them; -1 where this PyTorch has none)."""
    size = getattr(torch._C._distributed_c10d, "_get_work_registry_size",
                   None)
    return size() if size else -1


def _watch_mode():
    """A dispatch mode that notes, at each functional collective that
    DTensor issues on plain tensors, the port's registrations and the
    unwaited native collectives just before it, and those just after it
    (a native collective stays in the registry until waited for; the
    synchronous ones never enter it)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpu_lbfgs_torch.dist import partitioned

    class Watch(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            from torch.distributed.tensor import DTensor

            if isinstance(func, torch._ops.HigherOrderOperator):
                return func(*args, **(kwargs or {}))
            if any(t is DTensor for t in types):
                return NotImplemented       # DTensor desugars it first
            collective = (func.namespace == "_c10d_functional"
                          and func._opname.startswith(
                              ("all_", "reduce_scatter")))
            before = (sorted(partitioned._LIBS), _registry())
            out = func(*args, **(kwargs or {}))
            if collective:
                self.seen.append(dict(op=func._opname,
                                      registrations=before[0],
                                      pending_before=before[1],
                                      pending_after=_registry()))
            return out

    return Watch()


#: The evaluations of a watched case that run under a ``_watch_mode``
#: (a dispatch mode in Python slows every operation of an evaluation).
WATCHED_EVALUATIONS = 4


def _watched(sharded, watch):
    """Wrap the partitioned callables that ``sharded`` builds, so that
    each evaluation of the caller's objective leaves a record in
    ``watch``: the unwaited native collectives after it, and for the first
    ``WATCHED_EVALUATIONS`` its collectives under a ``_watch_mode``
    (None after them); return a function that puts them back."""
    saved = sharded.partitioned_value, sharded.partitioned_value_and_grad

    def wrap(make):
        def made(*args, **kwargs):
            fn = make(*args, **kwargs)

            def call(*xs):
                if len(watch) >= WATCHED_EVALUATIONS:
                    res, seen = fn(*xs), None
                else:
                    mode = _watch_mode()
                    with mode:
                        res = fn(*xs)
                    seen = mode.seen
                watch.append(dict(collectives=seen,
                                  pending_after=_registry()))
                return res
            return call
        return made

    sharded.partitioned_value = wrap(saved[0])
    sharded.partitioned_value_and_grad = wrap(saved[1])

    def restore():
        sharded.partitioned_value, sharded.partitioned_value_and_grad = saved
    return restore


ASYNC_GATHERS = 4


def _async_redistribution(mesh, x_local):
    """A caller's objective that asks DTensor for ``ASYNC_GATHERS``
    asynchronous all-gathers of x (``redistribute(..., async_op=True)``)
    before it reads any, evaluated once on the 1-D mesh: the native
    collectives that are in flight once all are asked for, and its value
    beside chained Rosenbrock's."""
    from torch.distributed.tensor import Replicate

    from tpu_lbfgs_torch.dist.partitioned import partitioned_value

    seen = {}

    def f(x):
        whole = [x.redistribute(placements=[Replicate()], async_op=True)
                 for _ in range(ASYNC_GATHERS)]
        seen["in_flight"] = _registry()
        return sum(torch_rosenbrock(w) for w in whole) / ASYNC_GATHERS

    value = partitioned_value(f, mesh, RAGGED)(x_local)
    want = partitioned_value(torch_rosenbrock, mesh, RAGGED)(x_local)
    return dict(seen, value=float(value), want=float(want))


def _rank(rank, size, cases):
    """Every case with the caller's objective, the evaluations of the
    first case and of the bounded batch cases watched (``_watched``); the named problem's solve beside the Rosenbrock
    cases; the collectives of one evaluation; one case again after
    registering the synchronous functional collectives for CPU tensors a
    second time (``_c10d_api_collectives``, which ``dist.partitioned``
    did before the first evaluation); then the job's shutdown and what it
    leaves alive."""
    from torch.distributed.tensor.debug import CommDebugMode

    from tpu_lbfgs_torch.dist import partitioned, sharded
    from tpu_lbfgs_torch.dist.mesh import local_block, pad_for_mesh
    from tpu_lbfgs_torch.dist.partitioned import (
        _c10d_api_collectives,
        partitioned_value_and_grad,
    )

    meshes = {"1d": tdist.make_mesh(), "2d": tdist.make_mesh_2d(ROWS)}
    out = {"cases": [], "named": {}, "watched": {},
           "registrations_at_start": sorted(partitioned._LIBS)}
    for i, c in enumerate(cases):
        if i == 0 or c["lockstep"] == "bounded":
            watch = []
            restore = _watched(sharded, watch)
            try:
                out["cases"].append(_solve(c, meshes))
            finally:
                restore()
            out["watched"][c["name"]] = watch
        else:
            out["cases"].append(_solve(c, meshes))
    for c in cases:
        if c["objective"] == "rosenbrock" and not c["batch"] \
                and not c["kw"]:
            cfg = tt.LBFGSConfig(**c["cfg"])
            res = tdist.sharded_minimize(
                None, torch.from_numpy(_x0(c)), cfg, meshes["1d"],
                problem="rosenbrock")
            out["named"][c["name"]] = _result(res, meshes["1d"], c["d"])
    counts = {}
    x = torch.from_numpy(_x0(BY_NAME["rosenbrock-261"]))
    x_local = local_block(pad_for_mesh(x, size)[0], meshes["1d"])
    for name, f in OBJECTIVES.items():
        vg = partitioned_value_and_grad(f, meshes["1d"], RAGGED)
        comm = CommDebugMode()
        with comm:
            vg(x_local)
        counts[name] = {str(k).split(".")[-1]: n
                        for k, n in comm.get_comm_counts().items()}
    out["counts"] = counts
    out["async_redistribution"] = _async_redistribution(meshes["1d"],
                                                        x_local)
    out["pending_at_registration"] = _registry()
    lib = partitioned._LIBS.get("CPU")
    _c10d_api_collectives("CPU")
    out["registered_again"] = partitioned._LIBS.get("CPU") is lib
    out["c10d_api"] = _solve(BY_NAME["rosenbrock-261"], meshes)
    out["after_shutdown"] = _shutdown_and_look(meshes)
    return out


def _backend_threads():
    """The names of this process's threads that belong to a group's
    backend or store (Linux names them; elsewhere None)."""
    import os

    if not os.path.isdir("/proc/self/task"):
        return None
    names = []
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as fh:
                names.append(fh.read().strip())
        except OSError:
            pass
    return sorted(n for n in names if "gloo" in n or "tcpstore" in n)


def _shutdown_and_look(meshes):
    """Leave the group as every spawned rank does (``dist.shutdown``),
    the caller's meshes dropped first, and report what still holds on:
    the groups the meshes used that are still alive, the backend's
    threads, and the port's registrations of the functional
    collectives."""
    import gc
    import weakref

    import torch.distributed as dist

    from tpu_lbfgs_torch.dist import partitioned

    groups = [weakref.ref(dist.group.WORLD)] + [
        weakref.ref(m.comm.group) for m in meshes.values()
        if m.comm is not None and m.comm.group is not None]
    meshes.clear()
    tdist.shutdown()
    gc.collect()
    return {"groups_alive": sum(g() is not None for g in groups),
            "backend_threads": _backend_threads(),
            "registrations": sorted(partitioned._LIBS)}


@pytest.fixture(scope="module")
def ranks():
    return spawn_ranks(_rank, RANKS, CASES, backend="gloo", timeout_s=180.0,
                       threads=1)


def _close(got, want, name, early, late, batch):
    got, want = np.asarray(got), np.asarray(want)
    if not batch:
        got, want = got[None], want[None]
    atol = 1e-14 * float(np.abs(want).max())
    np.testing.assert_allclose(got[:, :TIGHT], want[:, :TIGHT], rtol=early,
                               atol=atol, err_msg=name)
    np.testing.assert_allclose(got[:, TIGHT:], want[:, TIGHT:], rtol=late,
                               atol=atol, err_msg=name + ", late")


def _compare(got, want, case):
    """A case's gathered result against another solve's (dicts of numpy):
    every iteration of the trace where there is one, the final fields."""
    batch = case["batch"]
    if "trace" in got:
        t, w = got["trace"], want["trace"]
        np.testing.assert_array_equal(t["alpha"], w["alpha"])
        for name in ("n_fev", "n_gev", "guards"):
            np.testing.assert_array_equal(t[name], w[name], err_msg=name)
        _close(t["f"], w["f"], "f", RTOL, LATE_RTOL, batch)
        _close(t["g_norm"], w["g_norm"], "g_norm", RTOL, LATE_RTOL, batch)
    for name in ("status", "iterations", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(np.asarray(got[name]),
                                      np.asarray(want[name]), err_msg=name)
    for name in ("f", "g_norm"):
        np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                   rtol=LATE_RTOL, err_msg=name)
    np.testing.assert_allclose(got["x"], np.asarray(want["x"]), rtol=1e-8,
                               atol=1e-9)


def _as_dict(res):
    out = {name: np.asarray(getattr(res, name)) for name in FIELDS}
    out["x"] = np.asarray(res.x)
    if res.trace is not None:
        out["trace"] = {name: np.asarray(getattr(res.trace, name))
                        for name in TRACED}
    return out


@pytest.mark.parametrize("name", NAMES)
def test_own_objective_equals_jax(ranks, name):
    """The same objective written in jnp through the JAX package's sharded
    solve on 4 virtual CPU devices: the reference hands it to XLA's
    partitioner, the port to DTensor."""
    import jax
    import jax.numpy as jnp

    import tpu_lbfgs as tl
    from tpu_lbfgs.dist import make_mesh, make_mesh_2d
    from tpu_lbfgs.dist import sharded_minimize as jax_sm
    from tpu_lbfgs.dist import sharded_vmap_minimize as jax_svm

    case = BY_NAME[name]
    got = ranks[0]["cases"][NAMES.index(name)]
    cfg = tl.LBFGSConfig(**case["cfg"])
    f = jax_objective(case["objective"])
    p = tl.get_problem("rosenbrock")
    kw = {}
    if case["kw"].get("dir_poly"):
        kw["dir_poly"] = p.dir_poly
    if case["kw"].get("grad"):
        kw["grad"] = p.grad
    devices = jax.devices()[:RANKS]
    x0 = jnp.asarray(_x0(case))
    if case["batch"]:
        res = jax_svm(f, x0, cfg, mesh=make_mesh_2d(ROWS, devices=devices),
                      lockstep=case["lockstep"], **kw)
    else:
        res = jax_sm(f, x0, cfg, mesh=make_mesh(devices=devices), **kw)
    _compare(got, _as_dict(res), case)


@pytest.mark.parametrize("name", NAMES)
def test_own_objective_equals_the_single_device_port(ranks, name):
    """The same torch objective through ``minimize`` / ``vmap_minimize``
    on one process (autograd's gradient there too); every rank holds the
    same gathered bits."""
    case = BY_NAME[name]
    i = NAMES.index(name)
    got = ranks[0]["cases"][i]
    cfg = tt.LBFGSConfig(**case["cfg"])
    p = tt.get_problem("rosenbrock")
    kw = {}
    if case["kw"].get("dir_poly"):
        kw["dir_poly"] = p.dir_poly
    if case["kw"].get("grad"):
        kw["grad"] = p.grad
    f = OBJECTIVES[case["objective"]]
    x0 = torch.from_numpy(_x0(case))
    if case["batch"]:
        want = tt.vmap_minimize(f, x0, cfg, lockstep=case["lockstep"], **kw)
    else:
        want = tt.minimize(f, x0, cfg, **kw)
    _compare(got, _as_dict(want), case)
    for other in ranks[1:]:
        np.testing.assert_array_equal(other["cases"][i]["x"], got["x"])
        np.testing.assert_array_equal(other["cases"][i]["f"], got["f"])


@pytest.mark.parametrize("name", ["rosenbrock-256", "rosenbrock-261",
                                  "rosenbrock-two-loop"])
def test_own_objective_equals_the_named_problem(ranks, name):
    """Chained Rosenbrock written out by the caller against the suite's by
    name (its shard-local value, gradient and edge exchanges)."""
    case = BY_NAME[name]
    _compare(ranks[0]["cases"][NAMES.index(name)], ranks[0]["named"][name],
             case)


def test_collectives_of_one_evaluation(ranks):
    """Shifted slices all-gather x (forward) and the gradient's pieces;
    an elementwise objective and its sum cross as one all-reduce."""
    for out in ranks:
        rosen, huber = out["counts"]["rosenbrock"], out["counts"]["huber"]
        assert set(rosen) == {"all_gather_into_tensor"}, rosen
        assert 1 <= rosen["all_gather_into_tensor"] <= 4, rosen
        assert huber == {"all_reduce": 1}, huber


def test_no_collective_is_pending_when_the_api_collectives_register(ranks):
    """``_c10d_api_collectives`` makes ``wait_tensor`` the identity: a
    native collective still in flight when it registers would never be
    waited for.  ``dist.partitioned`` registers it before DTensor issues
    its first collective, so none is (PyTorch's registry of unwaited
    collectives is empty there), nor later, when the job registers it a
    second time."""
    for out in ranks:
        first = out["watched"][NAMES[0]][0]["collectives"][0]
        assert first["registrations"] == ["CPU"], first
        assert first["pending_before"] in (-1, 0), first
        assert out["pending_at_registration"] in (-1, 0), out[
            "pending_at_registration"]


def test_the_cpu_collectives_are_registered_before_the_first_evaluation(
        ranks):
    """A caller's own objective on CPU tensors takes the card's route: no
    registration before the port's first DTensor, and from the rank's
    first evaluation on, at every functional collective of its first
    case, the synchronous ones for CPU tensors in place, with nothing
    left in the registry of native work after it."""
    for out in ranks:
        assert out["registrations_at_start"] == [], out[
            "registrations_at_start"]
        watch = out["watched"][NAMES[0]]
        assert watch[0]["collectives"], watch[0]
        for evaluation in watch:
            for seen in evaluation["collectives"] or []:
                assert seen["registrations"] == ["CPU"], seen
                assert seen["pending_after"] in (-1, 0), seen
            assert evaluation["pending_after"] in (-1, 0), evaluation


@pytest.mark.parametrize(
    "name", [n for n in NAMES if BY_NAME[n]["lockstep"] == "bounded"])
def test_no_native_work_is_pending_in_a_bounded_batch(ranks, name):
    """A bounded batch case (where a gloo worker of PyTorch's asynchronous
    all-gather once found the heap corrupted) goes through the
    synchronous collectives: each functional collective of its watched
    evaluations leaves nothing in the registry of native work, and no
    evaluation ends with a native collective pending."""
    for out in ranks:
        watch = out["watched"][name]
        assert len(watch) > WATCHED_EVALUATIONS, name
        seen = [c for w in watch for c in w["collectives"] or []]
        assert seen, name
        assert {c["op"] for c in seen} == {"all_gather_into_tensor"}, {
            c["op"] for c in seen}
        for c in seen:
            assert c["registrations"] == ["CPU"], c
            assert c["pending_after"] in (-1, 0), c
        assert all(w["pending_after"] in (-1, 0) for w in watch), name


def test_shutdown_lets_go_of_the_groups(ranks):
    """After a caller's own objective (DTensor over the port's meshes,
    through the synchronous functional collectives), ``dist.shutdown``
    ends every group: none is still alive, no thread of the backend or of
    the store runs on into interpreter exit, and the functional
    collectives are PyTorch's own again."""
    for out in ranks:
        after = out["after_shutdown"]
        assert after["groups_alive"] == 0, after
        assert after["backend_threads"] in (None, []), after
        assert after["registrations"] == [], after


def test_asynchronous_redistributions_run_one_at_a_time(ranks):
    """A caller's objective may ask DTensor for several asynchronous
    all-gathers before it reads any; through PyTorch's native functional
    collectives they are then in flight on one gloo group at once, which
    is where a gloo worker found the heap corrupted.  Through the
    synchronous ones each has finished when the next is asked for: none
    is in flight, and the value is chained Rosenbrock's."""
    for out in ranks:
        got = out["async_redistribution"]
        assert got["in_flight"] in (-1, 0), got
        np.testing.assert_allclose(got["value"], got["want"], rtol=1e-15)


def test_c10d_api_collectives_give_the_same_solve(ranks):
    """Registering the synchronous functional collectives for CPU tensors
    again, late in the job, keeps ``dist.partitioned``'s registration
    (the same library) and gives the same solve bit for bit."""
    for out in ranks:
        assert out["registered_again"], out["registered_again"]
        want = out["cases"][NAMES.index("rosenbrock-261")]
        got = out["c10d_api"]
        np.testing.assert_array_equal(got["x"], want["x"])
        np.testing.assert_array_equal(got["trace"]["f"], want["trace"]["f"])
