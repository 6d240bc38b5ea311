"""The solve loops in blocks of iterations (``tpu_lbfgs_torch.core.blocks``)
against the per-iteration loop they replace and against the JAX package's
loops, on the CPU.

On the card a block is a replayed CUDA graph; here the same blocks run
eagerly: the loop condition computed on the device and handed to
``iterate`` as its lanes mask, the freeze, the state written back into the
runner's buffers, one host read per block.  So these tests cover what a
graph holds, and ``chip_smoke.py`` ``[graph]`` holds the replay to the
eager run on the card.

The per-iteration loop is the solver's own, reached by telling
``solver._blocked`` that no solve runs in blocks.  Every comparison with
it is bit for bit in float64, every field of the state.  Against the JAX
package: status, iterations and counters equal, f and x within
``tests/test_torch_general.py``'s float64 step tolerance.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from tpu_lbfgs.batch import vmap_minimize as jax_vmap_minimize
from tpu_lbfgs_torch.core import blocks, solver
from tpu_lbfgs_torch.io import load_state, save_state
from tpu_lbfgs_torch.kernels import counts

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(tt.LBFGSState)]
BENCH = dict(line_search="backtracking", direction="compact_incremental",
             m=10, ls_eval="polynomial")
# tests/test_torch_general.py: float64 Rosenbrock steps of the two
# packages stay within 1e-8 relative over 40 iterations.
STEP_RTOL = 1e-8
D = 64
# Chained Rosenbrock with a wall: f is infinite once any coordinate passes
# WALL, so the search's accepted step fails in the tail (a non-finite f)
# and the solve ends LINE_SEARCH_FAILED where the trajectory first
# crosses it.
WALL = 1.05


def _x0(seed=0, d=D, lanes=None, center=-1.2):
    shape = (d,) if lanes is None else (lanes, d)
    return center + np.random.default_rng(seed).uniform(-0.1, 0.1, shape)


def _walled(pkg):
    p = pkg.get_problem("rosenbrock")
    if pkg is tl:
        def f(x):
            return jnp.where(jnp.max(x) < WALL, p.f(x), jnp.inf)
    else:
        def f(x):
            return torch.where(x.max() < WALL, p.f(x), torch.inf)
    return f, p.grad, p.dir_poly


def _parts(pkg, end):
    """(f, grad, dir_poly) of the case's problem in ``pkg``."""
    if end == "failed":
        return _walled(pkg)
    p = pkg.get_problem("rosenbrock")
    return p.f, p.grad, p.dir_poly


# How each solve ends: its config keywords and its start's center; at
# D = 64 the tol case converges in 38 iterations, the walled one fails in
# its 8th.
ENDS = {"tol": dict(tol=1e-3, max_iters=200),
        "max_iters": dict(tol=0.0, max_iters=23),
        "failed": dict(tol=0.0, max_iters=200, fidelity="fixed")}
CENTER = {"tol": 0.8, "max_iters": -1.2, "failed": -1.2}
END_STATUS = {"tol": tt.Status.CONVERGED, "max_iters": tt.Status.MAX_ITERS,
              "failed": tt.Status.LINE_SEARCH_FAILED}


def _assert_equal_states(a, b):
    for name in FIELDS:
        ta, tb = getattr(a, name), getattr(b, name)
        assert ta.dtype == tb.dtype and ta.shape == tb.shape, name
        assert torch.equal(ta, tb), name


def _per_iteration(monkeypatch):
    """Run the solver's per-iteration loop from here on."""
    monkeypatch.setattr(solver, "_blocked", lambda *a, **k: False)


def _solve(kind, cfg, f, grad, dir_poly, x0, **kw):
    vg = tt.make_value_and_grad(f, grad)
    state = tt.init_state(vg, torch.from_numpy(x0), cfg.m)
    if kind == "segment":
        seg = tt.make_solve_segment(cfg, f, grad=grad, dir_poly=dir_poly,
                                    **kw)
        return seg(state)
    fn = tt.solve_bounded if kind == "bounded" else tt.solve_from_state
    return fn(cfg, f, vg, state, dir_poly)


def _jax_solve(kind, cfg, f, grad, dir_poly, x0, **kw):
    vg = tl.make_value_and_grad(f, grad)
    state = tl.init_state(vg, jnp.asarray(x0), cfg.m)
    if kind == "segment":
        return tl.make_solve_segment(cfg, f, grad=grad, dir_poly=dir_poly,
                                     donate=False, **kw)(state)
    fn = tl.solve_bounded if kind == "bounded" else tl.solve_from_state
    return jax.jit(lambda s: fn(cfg, f, vg, s, dir_poly))(state)


def _assert_matches_jax(st, sj):
    """Status, iterations and counters equal; f and x to STEP_RTOL."""
    for name in ("status", "k", "n_pairs", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(st.f.numpy(), np.asarray(sj.f),
                               rtol=STEP_RTOL)
    np.testing.assert_allclose(st.x.numpy(), np.asarray(sj.x),
                               rtol=STEP_RTOL, atol=1e-12)


# --- one masked iteration ---------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(damping=0.2),
                                dict(direction="two_loop")],
                         ids=["main", "damped", "two_loop"])
def test_a_true_0d_mask_equals_no_mask(kw):
    """``iterate(lanes=tensor(True))``, how a block steps one instance,
    equals ``iterate(lanes=None)``, how the per-iteration loop steps it,
    bit for bit over 12 float64 iterations; ``lanes=tensor(False)`` leaves
    every field, the ring's rows included, as it was."""
    cfg = tt.LBFGSConfig(**{**BENCH, **kw}, tol=0.0)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)

    def fresh():
        return tt.init_state(vg, torch.from_numpy(_x0(3)), cfg.m)

    a, b = fresh(), fresh()
    on, off = torch.tensor(True), torch.tensor(False)
    for _ in range(12):
        a = tt.iterate(cfg, p.f, vg, a, p.dir_poly)
        b = tt.iterate(cfg, p.f, vg, b, p.dir_poly, lanes=on)
        _assert_equal_states(a, b)
    before = dataclasses.replace(
        b, **{n: getattr(b, n).clone() for n in FIELDS})
    _assert_equal_states(tt.iterate(cfg, p.f, vg, b, p.dir_poly, lanes=off),
                         before)
    _assert_equal_states(b, before)


# --- blocks against the per-iteration loop ----------------------------------

@pytest.mark.parametrize("n_block", [1, 7, 50])
@pytest.mark.parametrize("end", list(ENDS))
def test_blocks_equal_the_per_iteration_loop(monkeypatch, end, n_block):
    """``solve_from_state`` in blocks of 1, 7 and 50 iterations equals the
    per-iteration loop bit for bit, every field, for a solve that ends by
    tol, by max_iters and by a failed line search, each inside a block;
    the host reads the flags at most ceil(n / N) + 2 times for n
    iterations (the loop read n + 1)."""
    cfg = tt.LBFGSConfig(**BENCH, **ENDS[end])
    f, grad, dir_poly = _parts(tt, end)
    monkeypatch.setattr(blocks, "BLOCK_ITERS", n_block)
    blocks.reset_stats()
    x0 = _x0(1, center=CENTER[end])
    got = _solve("while", cfg, f, grad, dir_poly, x0)
    reads, steps = blocks.stats["host_reads"], blocks.stats["steps"]
    _per_iteration(monkeypatch)
    want = _solve("while", cfg, f, grad, dir_poly, x0)
    _assert_equal_states(got, want)
    n = got.k.item()
    assert got.status.item() == END_STATUS[end]
    assert 1 < n < 50 and n % 7, n       # inside a block of 7 and of 50
    assert reads <= math.ceil(n / n_block) + 2, (reads, n)
    assert n <= steps < n + n_block


@pytest.mark.parametrize("kind", ["while", "bounded"])
def test_refresh_edges_in_blocks(monkeypatch, kind):
    """With ``refresh_interval`` = 9 over 40 iterations (four segments and a
    remainder of 4) and blocks of 7 (segments of one block and 2 single
    iterations): ``solve_from_state`` and ``solve_bounded`` equal the
    per-iteration loop bit for bit, and the JAX package's solve."""
    cfg = tt.LBFGSConfig(**BENCH, tol=0.0, max_iters=40, refresh_interval=9)
    f, grad, dir_poly = _parts(tt, "tol")
    monkeypatch.setattr(blocks, "BLOCK_ITERS", 7)
    blocks.reset_stats()
    got = _solve(kind, cfg, f, grad, dir_poly, _x0(2))
    assert blocks.stats["steps"] == 40
    if kind == "bounded":
        assert blocks.stats["host_reads"] == 0
    _per_iteration(monkeypatch)
    _assert_equal_states(got, _solve(kind, cfg, f, grad, dir_poly, _x0(2)))
    fj, gj, pj = _parts(tl, "tol")
    _assert_matches_jax(got, _jax_solve(
        kind, tl.LBFGSConfig(**BENCH, tol=0.0, max_iters=40,
                             refresh_interval=9), fj, gj, pj, _x0(2)))


def _lanes_x0():
    """Rosenbrock lanes that stop at different iterations: two near the
    minimum, which reach tol = 0.1 in 6 and 15 iterations, one with an
    infinite coordinate, which fails at iteration 1, the others from -1.2 +
    U(-0.1, 0.1), which run to max_iters = 30."""
    x0 = _x0(4, d=32, lanes=6)
    x0[1] = 1.0 + np.random.default_rng(5).uniform(-1e-3, 1e-3, 32)
    x0[4] = 1.0 + np.random.default_rng(6).uniform(-2e-1, 2e-1, 32)
    x0[2, 7] = np.inf
    return x0


def test_while_batch_lanes_finish_in_different_blocks(monkeypatch):
    """``vmap_minimize(lockstep="while")`` in blocks of 7: lanes that end in
    different blocks (at iterations 1, 6, 15 and 30) freeze where they end,
    equal to the per-iteration loop bit for bit, and to the JAX package's
    vmapped solve."""
    cfg = tt.LBFGSConfig(**BENCH, tol=1e-1, max_iters=30)
    p = tt.get_problem("rosenbrock")
    monkeypatch.setattr(blocks, "BLOCK_ITERS", 7)
    x0 = _lanes_x0()

    def run():
        return tt.vmap_minimize(p.f, torch.from_numpy(x0), cfg, grad=p.grad,
                                dir_poly=p.dir_poly)

    blocks.reset_stats()
    got = run()
    reads = blocks.stats["host_reads"]
    iters = got.iterations.numpy()
    assert len(set(iters // 7)) >= 3, iters
    assert reads <= math.ceil(iters.max() / 7) + 2
    _per_iteration(monkeypatch)
    want = run()
    for name in tt.SolveResult._fields:
        if name != "trace":
            torch.testing.assert_close(getattr(got, name),
                                       getattr(want, name), rtol=0, atol=0,
                                       equal_nan=True, msg=name)
    pj = tl.get_problem("rosenbrock")
    ref = jax_vmap_minimize(pj.f, jnp.asarray(x0),
                            tl.LBFGSConfig(**BENCH, tol=1e-1, max_iters=30),
                            grad=pj.grad, dir_poly=pj.dir_poly)
    for name in ("status", "iterations", "n_fev", "n_gev", "guards"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    live = got.status.numpy() != tt.Status.LINE_SEARCH_FAILED
    np.testing.assert_allclose(got.f.numpy()[live], np.asarray(ref.f)[live],
                               rtol=STEP_RTOL)


def test_segments_resume_across_a_checkpoint(monkeypatch, tmp_path):
    """``make_solve_segment`` of 11 iterations in blocks of 7, with
    ``refresh_interval``: three segments cut after the second by
    ``io.save_state`` / ``load_state`` equal the same segments uncut, bit
    for bit, equal the per-iteration loop, and match the JAX package's
    segments.  The segment function keeps its buffers: a call with the
    state it returned copies nothing in."""
    cfg = tt.LBFGSConfig(**BENCH, tol=0.0, max_iters=30, refresh_interval=11)
    f, grad, dir_poly = _parts(tt, "tol")
    vg = tt.make_value_and_grad(f, grad)
    monkeypatch.setattr(blocks, "BLOCK_ITERS", 7)

    def segment():
        return tt.make_solve_segment(cfg, f, grad=grad, dir_poly=dir_poly,
                                     iters=11)

    def start():
        return tt.init_state(vg, torch.from_numpy(_x0(7)), cfg.m)

    seg = segment()
    first = seg(start())
    ks = [first.k.item()]
    second = seg(first)
    assert second.x is first.x and second.s_hist is first.s_hist
    ks.append(second.k.item())
    uncut = seg(second)
    assert ks + [uncut.k.item()] == [11, 22, 30]
    uncut = dataclasses.replace(
        uncut, **{n: getattr(uncut, n).clone() for n in FIELDS})

    seg = segment()
    mid = seg(seg(start()))
    save_state(tmp_path / "mid.npz", mid)
    resumed = segment()(load_state(tmp_path / "mid.npz", device="cpu"))
    _assert_equal_states(resumed, uncut)

    _per_iteration(monkeypatch)
    seg = segment()
    _assert_equal_states(seg(seg(seg(start()))), uncut)

    fj, gj, pj = _parts(tl, "tol")
    cj = tl.LBFGSConfig(**BENCH, tol=0.0, max_iters=30, refresh_interval=11)
    seg_j = tl.make_solve_segment(cj, fj, grad=gj, dir_poly=pj, iters=11,
                                  donate=False)
    sj = tl.init_state(tl.make_value_and_grad(fj, gj), jnp.asarray(_x0(7)),
                       cj.m)
    _assert_matches_jax(uncut, seg_j(seg_j(seg_j(sj))))


@pytest.mark.parametrize("end", ["tol", "failed"])
def test_blocks_match_jax_solve_from_state(monkeypatch, end):
    """``solve_from_state`` in blocks of 7 against the JAX package's
    ``solve_from_state`` (a ``lax.while_loop``) from the same state: the
    same end at the same iteration."""
    monkeypatch.setattr(blocks, "BLOCK_ITERS", 7)
    kw, x0 = ENDS[end], _x0(1, center=CENTER[end])
    got = _solve("while", tt.LBFGSConfig(**BENCH, **kw), *_parts(tt, end),
                 x0)
    want = _jax_solve("while", tl.LBFGSConfig(**BENCH, **kw),
                      *_parts(tl, end), x0)
    assert got.status.item() == END_STATUS[end]
    _assert_matches_jax(got, want)


# --- which loop runs ----------------------------------------------------------

def test_eager_paths_are_chosen_by_their_arguments(monkeypatch):
    """The per-iteration loop runs, and no block, for a search that reads
    on the host (direct-mode backtracking on one instance), a traced
    solve, and under ``set_debug_nans(True)``; ``solve_bounded`` runs its
    fixed-trip search in blocks in direct mode too, blocks that are never
    captured for a batch whose search loops."""
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    x0 = torch.from_numpy(_x0(0))
    direct = tt.LBFGSConfig(line_search="backtracking", ls_eval="direct",
                            max_iters=5, tol=0.0)
    cases = {"direct": (direct, None),
             "traced": (tt.LBFGSConfig(**BENCH, max_iters=5,
                                       record_trace=True), p.dir_poly)}
    for label, (cfg, poly) in cases.items():
        blocks.reset_stats()
        out = tt.solve_from_state(cfg, p.f, vg, tt.init_state(vg, x0, cfg.m),
                                  poly)
        assert out.k.item() == 5, label
        assert blocks.stats["steps"] == 0, label
    blocks.reset_stats()
    tt.solve_bounded(direct, p.f, vg, tt.init_state(vg, x0, direct.m))
    assert blocks.stats["steps"] == 5
    cfg = tt.LBFGSConfig(**BENCH, max_iters=5, tol=0.0)
    solver.set_debug_nans(True)
    try:
        blocks.reset_stats()
        tt.solve_from_state(cfg, p.f, vg, tt.init_state(vg, x0, cfg.m),
                            p.dir_poly)
        assert blocks.stats["steps"] == 0
    finally:
        solver.set_debug_nans(False)
    state = tt.init_state(vg, x0, cfg.m)
    assert solver._blocked(cfg, state, None, False)
    assert not solver._blocked(cfg, state, object(), True)
    # solve_bounded's blocks of a batch under a search that loops are never
    # captured; one instance's are.
    batch = tt.init_state(vg, torch.from_numpy(_x0(0, lanes=3)), cfg.m)
    wolfe = direct.replace(line_search="backtracking_wolfe")
    assert not solver._captured(wolfe, batch, bounded=True)
    assert solver._captured(wolfe, batch, bounded=False)
    assert solver._captured(direct, batch, bounded=True)
    assert solver._captured(wolfe, state, bounded=True)
    assert solver._captured(cfg, state, bounded=True)


def test_kept_runners_replay_for_a_second_solve(monkeypatch):
    """With a ``blocks.Kept`` a second solve of the same configuration,
    callables and shapes reuses the first one's runner, its state copied
    in: the result equals a solve of its own, and the first solve's
    returned state is overwritten (the kept buffers); a third with another
    max_iters reuses it too and equals a solve of its own."""
    cfg = tt.LBFGSConfig(**BENCH, tol=0.0, max_iters=15)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    monkeypatch.setattr(blocks, "BLOCK_ITERS", 7)

    def run(seed, kept=None):
        state = tt.init_state(vg, torch.from_numpy(_x0(seed)), cfg.m)
        return tt.solve_from_state(cfg, p.f, vg, state, p.dir_poly,
                                   kept=kept)

    alone = run(9)
    alone = dataclasses.replace(
        alone, **{n: getattr(alone, n).clone() for n in FIELDS})
    kept = blocks.Kept()
    first = run(8, kept)
    runner = kept.runner
    second = run(9, kept)
    assert kept.runner is runner
    assert second.x is runner.s.x and first.x is second.x
    _assert_equal_states(second, alone)
    # The caps are device tensors: another max_iters, the same runner.
    cfg = cfg.replace(max_iters=22)
    longer = run(9, kept)
    assert kept.runner is runner and longer.k.item() == 22
    _assert_equal_states(longer, run(9))


def test_a_kept_runner_is_rebuilt_for_another_route(monkeypatch):
    """A kept runner serves only solves of its own route: another chain
    rule (``chain.whole_batch``), another configuration or another shape
    builds a new runner, whose solve equals one of its own."""
    cfg = tt.LBFGSConfig(**BENCH, tol=0.0, max_iters=9)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    monkeypatch.setattr(blocks, "BLOCK_ITERS", 4)
    kept = blocks.Kept()

    def run(c, lanes=None, kept=kept):
        x0 = torch.from_numpy(_x0(5, d=16, lanes=lanes))
        return tt.solve_bounded(c, p.f, vg, tt.init_state(vg, x0, c.m),
                                p.dir_poly, kept=kept)

    run(cfg, 4)
    runners = [kept.runner]
    with tt.kernels.chain.whole_batch(1024):
        got = run(cfg, 4)
        runners.append(kept.runner)
        _assert_equal_states(got, run(cfg, 4, None))
    run(cfg.replace(m=4), 4)
    runners.append(kept.runner)
    run(cfg, 3)
    runners.append(kept.runner)
    assert len({id(r) for r in runners}) == len(runners)


def test_an_undonated_segment_never_changes_an_earlier_result():
    """``make_solve_segment(donate=False)`` returns a state of its own from
    each call, as the reference's fresh outputs: a later call leaves an
    earlier result as it was.  ``donate=True`` returns the kept buffers."""
    cfg = tt.LBFGSConfig(**BENCH, tol=0.0, max_iters=30)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)

    def start(seed):
        return tt.init_state(vg, torch.from_numpy(_x0(seed)), cfg.m)

    for donate in (False, True):
        seg = tt.make_solve_segment(cfg, p.f, grad=p.grad,
                                    dir_poly=p.dir_poly, iters=6,
                                    donate=donate)
        a = seg(start(1))
        kept = {n: getattr(a, n).clone() for n in FIELDS}
        b = seg(start(2))
        changed = [n for n in FIELDS if not torch.equal(getattr(a, n),
                                                         kept[n])]
        if donate:
            assert a.x is b.x and "x" in changed
        else:
            assert not changed


def test_launch_counts_see_through_captures():
    """A launch made while a graph is captured counts nothing until the
    graph runs; each replay adds the capture's launches to
    ``launch_counts()`` and ``replay_counts()``."""
    tt.kernels.reset_launches()
    name = "rosenbrock_fused_tail"
    with counts.recording() as tally:
        counts.count(tt.kernels.fused_ops.launches, name)
        counts.count(tt.kernels.fused_ops.launches, name)
    assert tt.kernels.launch_counts()[name] == 0 and tally[name] == 2
    for _ in range(3):
        counts.replay(tally)
    counts.count(tt.kernels.fused_ops.launches, name)
    assert tt.kernels.launch_counts()[name] == 7
    assert tt.kernels.replay_counts()[name] == 6
    tt.kernels.reset_launches()
    assert not any(tt.kernels.launch_counts().values())
    assert not any(tt.kernels.replay_counts().values())


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("ls_eval", ["polynomial", "direct"])
@pytest.mark.parametrize("search", tt.config.LINE_SEARCH_METHODS)
def test_reads_on_host_names_the_searches_that_read(search, ls_eval,
                                                    batched):
    """``strategies.reads_on_host``, which keeps a solve on the
    per-iteration loop, says of each search, evaluation and lane shape
    whether one read-driven iterate reads its loop condition on the host."""
    from tpu_lbfgs_torch.linesearch import strategies

    cfg = tt.LBFGSConfig(line_search=search, ls_eval=ls_eval, m=4,
                         tol=0.0)
    p = tt.get_problem("rosenbrock")
    vg = tt.make_value_and_grad(p.f, p.grad)
    x0 = _x0(0, d=16, lanes=3 if batched else None)
    state = tt.init_state(vg, torch.from_numpy(x0), cfg.m)
    strategies.reset_host_reads()
    tt.iterate(cfg, p.f, vg, state, p.dir_poly)
    reads = strategies.host_reads["line_search"]
    assert strategies.reads_on_host(cfg, batched) == (reads > 0), reads
