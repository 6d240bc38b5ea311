"""The sharded checkpoint (``io.save_state_sharded`` / ``load_state_sharded``),
the state-in / state-out sharded entry (``dist.sharded.solve_shard_from_state``)
and the host-ordered meshes (``dist.multihost.global_mesh`` /
``global_mesh_2d``) of tpu_lbfgs_torch, on 4 CPU processes (gloo), float64.

One spawn of 4 ranks runs everything that needs the group; a module-scoped
fixture holds the results.  A solve saved at SAVE_ITERS on 4 ranks and
resumed to 2 * SAVE_ITERS equals the uncut solve bit for bit on 4 ranks and
to 1e-12 on 2 ranks (a subgroup) and on 1 (rank 0 alone), where the sums
cross fewer partials; the directory's refusals are the reference's.

The ranks import this module to find their functions, so it imports JAX and
the JAX package only inside the tests that compare with them.
"""
import json
import shutil

import numpy as np
import pytest
import torch

import tpu_lbfgs_torch as tt
from tpu_lbfgs_torch import dist as tdist
from tpu_lbfgs_torch.dist.launch import spawn_ranks

torch.set_num_threads(1)

RANKS = 4
D = 261
SAVE_ITERS = 10
CFG = dict(line_search="backtracking", direction="compact_incremental",
           ls_eval="polynomial", tol=0.0)
RESUME_TOL = 1e-12


def _x0(shape, dtype=torch.float64):
    return torch.from_numpy(np.random.default_rng(0).uniform(
        -2.0, 2.0, shape)).to(dtype)


def _whole(res, mesh):
    return tdist.gather_result(res, mesh, D).x.numpy()


def _checkpoint(rank, size, root):
    """Save at SAVE_ITERS on the 4 ranks, go on to 2 * SAVE_ITERS (the
    uncut solve), resume from the files on 4 ranks, on ranks 0 and 1, and
    on rank 0 alone."""
    import torch.distributed as torch_dist

    from tpu_lbfgs_torch.dist.mesh import Mesh, local_block, pad_for_mesh
    from tpu_lbfgs_torch.dist.sharded import (
        solve_shard,
        solve_shard_from_state,
    )
    from tpu_lbfgs_torch.io import load_state_sharded, save_state_sharded

    mesh = tdist.make_mesh()
    cfg = tt.LBFGSConfig(max_iters=SAVE_ITERS, **CFG)
    cfg2 = cfg.replace(max_iters=2 * SAVE_ITERS)
    out = {}
    for kernels in (False, True):
        path = f"{root}/ck-{kernels}"
        x_pad, n = pad_for_mesh(_x0(D), size)
        _, state = solve_shard("rosenbrock", local_block(x_pad, mesh), n, cfg,
                               mesh, kernels, return_state=True)
        save_state_sharded(path, state, mesh, D)

        def resume(st, on):
            return solve_shard_from_state(st, n, cfg2, on, "rosenbrock",
                                          kernels)[0]

        uncut = resume(state, mesh)
        on4 = resume(load_state_sharded(path, mesh, device="cpu"), mesh)
        rec = {"uncut": _whole(uncut, mesh), "on4": _whole(on4, mesh),
               "k": (int(uncut.iterations), int(on4.iterations)),
               "f": (float(uncut.f), float(on4.f))}
        pair = torch_dist.new_group([0, 1])
        if rank < 2:
            mesh2 = tdist.make_mesh(pair)
            on2 = resume(load_state_sharded(path, mesh2, device="cpu"), mesh2)
            rec["on2"] = _whole(on2, mesh2)
            rec["shape2"] = tuple(load_state_sharded(path, mesh2,
                                                     device="cpu").x.shape)
        if rank == 0:
            alone = Mesh(None)
            on1 = resume(load_state_sharded(path, alone, device="cpu"), alone)
            rec["on1"] = on1.x.numpy()
        torch_dist.barrier()
        out[f"kernels={kernels}"] = rec
    # A bfloat16 ring: the round trip on the same mesh, field for field.
    cfg_b = tt.LBFGSConfig(max_iters=5, history_dtype="bfloat16", **CFG)
    x_pad, n = pad_for_mesh(_x0(D, torch.float32), size)
    _, state = solve_shard("rosenbrock", local_block(x_pad, mesh), n, cfg_b,
                           mesh, True, return_state=True)
    save_state_sharded(f"{root}/bf16", state, mesh, D)
    back = load_state_sharded(f"{root}/bf16", mesh, device="cpu")
    out["bf16"] = {
        name: (getattr(back, name).dtype == getattr(state, name).dtype
               and torch.equal(getattr(back, name), getattr(state, name)))
        for name in ("x", "g", "s_hist", "y_hist", "SY", "k", "status",
                     "guards")}
    out["bf16_dtype"] = str(back.s_hist.dtype)
    # A batch on the 2 x 2 mesh: its lanes saved by rows, restored on the
    # same mesh and, whole, on rank 0 alone.
    mesh2d = tdist.make_mesh_2d(2)
    xb = _x0((4, D))
    x_rows = tdist.mesh.local_lanes(xb, mesh2d)
    x_pad, n = pad_for_mesh(x_rows, mesh2d.size)
    _, bstate = solve_shard("rosenbrock", local_block(x_pad, mesh2d), n,
                            tt.LBFGSConfig(max_iters=4, **CFG), mesh2d, False,
                            return_state=True)
    save_state_sharded(f"{root}/batch", bstate, mesh2d, D)
    back = load_state_sharded(f"{root}/batch", mesh2d, device="cpu")
    out["batch_same"] = all(torch.equal(getattr(back, f), getattr(bstate, f))
                            for f in ("x", "g", "s_hist", "f", "k"))
    torch_dist.barrier()
    if rank == 0:
        from tpu_lbfgs_torch.dist.mesh import Mesh

        whole = load_state_sharded(f"{root}/batch", Mesh(None), device="cpu")
        out["batch_whole"] = (tuple(whole.x.shape), whole.x.numpy(),
                              whole.f.numpy())
    out["batch_rows"] = (tdist.gather_result(
        tt.SolveResult(bstate.x, bstate.f, bstate.g_norm, bstate.k,
                       bstate.status, bstate.n_fev, bstate.n_gev,
                       guards=bstate.guards),
        mesh2d, D).x.numpy())
    return out


def _meshes(rank, size):
    """The host-ordered meshes with two made-up hosts, ranks 0 and 2 on
    "a", 1 and 3 on "b"; a solve on the reordered 1-D mesh; the
    refusals."""
    host = "a" if rank % 2 == 0 else "b"
    gm = tdist.global_mesh(host=host)
    out = {"place": (gm.rank, gm.size, gm.comm.order)}
    res = tdist.sharded_minimize(
        None, _x0(D), tt.LBFGSConfig(max_iters=20, record_trace=True, **CFG),
        gm, problem="rosenbrock", dir_poly=True)
    out["x"] = tdist.gather_result(res, gm, D).x.numpy()
    out["f"] = res.trace.f.numpy()
    gm2 = tdist.global_mesh_2d(2, host=host)
    out["place2"] = (gm2.batch_rank, gm2.rank, gm2.comm.order,
                     gm2.grid.order)
    for key, call in {
            "rows": lambda: tdist.global_mesh_2d(3, host=host),
            "own": lambda: tdist.sharded_minimize(
                lambda x: (x * x).sum(-1), _x0(D),
                tt.LBFGSConfig(max_iters=2), gm)}.items():
        try:
            call()
            out[key] = None
        except ValueError as e:
            out[key] = str(e)
    out["same_host"] = tdist.global_mesh(host="one").comm.order
    return out


def _rank(rank, size, root):
    return {"ckpt": _checkpoint(rank, size, root),
            "meshes": _meshes(rank, size)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    out = spawn_ranks(_rank, RANKS, str(root), backend="gloo",
                      timeout_s=180.0, threads=1)
    return root, out


@pytest.mark.parametrize("path", ["kernels=False", "kernels=True"])
def test_resume_on_4_2_and_1_ranks_equals_the_uncut_solve(ranks, path):
    """Saved on 4 ranks at iteration 10, resumed to 20: bit for bit on the
    same 4 ranks, to 1e-12 on 2 and on 1 (whose blocks are laid out anew,
    and whose float64 sums cross fewer partials); the plain shard-local
    path and the kernel path (its plain versions here)."""
    _, out = ranks
    rec = out[0]["ckpt"][path]
    assert rec["k"] == (2 * SAVE_ITERS, 2 * SAVE_ITERS)
    assert rec["f"][0] == rec["f"][1]
    np.testing.assert_array_equal(rec["on4"], rec["uncut"])
    for key in ("on2", "on1"):
        assert rec[key].shape == (D,)
        np.testing.assert_allclose(rec[key], rec["uncut"], rtol=0,
                                   atol=RESUME_TOL)
    # d = 261 on 2 ranks: blocks of 131, the last padded by one.
    assert out[0]["ckpt"][path]["shape2"] == (131,)
    for other in out[1:]:
        np.testing.assert_array_equal(other["ckpt"][path]["on4"],
                                      rec["on4"])


def test_the_directory_and_its_index(ranks):
    """One file per rank and the commit marker, with the unpadded d and
    the padded global shapes."""
    root, _ = ranks
    names = sorted(p.name for p in (root / "ck-False").iterdir())
    assert names == ["index.json"] + [f"shard-{r}.npz" for r in range(RANKS)]
    index = json.loads((root / "ck-False" / "index.json").read_text())
    assert index["schema"] == "tpu-lbfgs-state-sharded-v1"
    assert index["num_processes"] == RANKS and index["d"] == D
    assert index["fields"]["s_hist"]["shape"] == [10, 264]
    assert index["fields"]["SY"]["shape"] == [10, 10]


def test_a_bf16_ring_round_trips(ranks):
    """A bfloat16 ring crosses as float32 and is narrowed back exactly."""
    _, out = ranks
    for r in out:
        assert r["ckpt"]["bf16_dtype"] == "torch.bfloat16"
        assert all(r["ckpt"]["bf16"].values()), r["ckpt"]["bf16"]


def test_a_batch_round_trips_by_rows(ranks):
    """A (b, d) mesh's lanes: back on the same mesh bit for bit, and the
    whole (B, d) state on one process equal to the gathered rows."""
    _, out = ranks
    for r in out:
        assert r["ckpt"]["batch_same"]
    shape, x, f = out[0]["ckpt"]["batch_whole"]
    assert shape == (4, D)
    np.testing.assert_array_equal(x, out[0]["ckpt"]["batch_rows"])
    assert np.isfinite(f).all()


def test_a_torn_or_stale_directory_is_refused(ranks, tmp_path):
    """Without index.json (a save cut before its commit) the load raises
    FileNotFoundError, as the reference's does; a shard file beyond the
    index's count (an older save with more ranks) and a missing committed
    file are refused too."""
    import tpu_lbfgs.io as jax_io

    from tpu_lbfgs_torch.dist.mesh import Mesh
    from tpu_lbfgs_torch.io import load_state_sharded

    root, _ = ranks
    torn = tmp_path / "torn"
    shutil.copytree(root / "ck-False", torn)
    (torn / "index.json").unlink()
    with pytest.raises(FileNotFoundError):
        load_state_sharded(torn, Mesh(None), device="cpu")
    with pytest.raises(FileNotFoundError):
        jax_io.load_state_sharded(torn, mesh=None)
    stale = tmp_path / "stale"
    shutil.copytree(root / "ck-False", stale)
    shutil.copy(stale / "shard-0.npz", stale / "shard-7.npz")
    with pytest.raises(ValueError, match="beyond"):
        load_state_sharded(stale, Mesh(None), device="cpu")
    (stale / "shard-7.npz").unlink()
    (stale / "shard-2.npz").unlink()
    with pytest.raises(FileNotFoundError, match="missing"):
        load_state_sharded(stale, Mesh(None), device="cpu")


def test_global_mesh_keeps_a_hosts_ranks_together(ranks):
    """Ranks 0 and 2 on one host, 1 and 3 on another: the mesh order is
    0, 2, 1, 3, so each host's ranks are neighbours on the vector axis; a
    solve on that mesh equals the single-device solve; one host keeps the
    group's order; a 2-D mesh keeps a row on one host."""
    _, out = ranks
    places = [r["meshes"]["place"] for r in out]
    assert [p[0] for p in places] == [0, 2, 1, 3]
    assert all(p[1] == RANKS and p[2] == [0, 2, 1, 3] for p in places)
    p = tt.get_problem("rosenbrock")
    single = tt.minimize(p.f, _x0(D), tt.LBFGSConfig(
        max_iters=20, record_trace=True, **CFG), grad=p.grad,
        dir_poly=p.dir_poly)
    np.testing.assert_allclose(out[0]["meshes"]["f"], single.trace.f.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(out[0]["meshes"]["x"], single.x.numpy(),
                               rtol=1e-8, atol=1e-9)
    assert all(r["meshes"]["same_host"] == [0, 1, 2, 3] for r in out)
    rows = [r["meshes"]["place2"] for r in out]
    # Rows (0, 2) and (1, 3): each row is one host's ranks.
    assert [(b, c) for b, c, _, _ in rows] == [(0, 0), (1, 0), (0, 1), (1, 1)]
    assert all(grid == [0, 2, 1, 3] for *_, grid in rows)


def test_global_mesh_refusals(ranks):
    """The reference's ValueError for a batch axis that does not divide
    the job; a caller's own objective on a reordered mesh (DTensor places
    shard r on the group's rank r)."""
    _, out = ranks
    for r in out:
        assert r["meshes"]["rows"] == "4 devices not divisible by batch axis 3"
        assert "rank order" in r["meshes"]["own"]
