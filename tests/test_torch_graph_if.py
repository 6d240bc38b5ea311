"""The gated line-search driver (``linesearch.strategies._gated``) on the
CPU, through the eager gate.

On the card each search loop inside a captured block is a CUDA graph
WHILE node whose body is the loop's one turn (``kernels.graph_if``); here
``strategies.EagerGate`` runs the turn while its predicate holds, so these
tests drive the gated driver's own code: the buffers, the per-lane freeze,
``enter``, the condition the turn rewrites.  ``chip_smoke.py``
``[direct]`` holds the graphs to the eager solve on the card.

- Every search, one instance and a batch, float32 and float64: the gated
  driver equals the read-driven and fixed-trip drivers bit for bit.
- Searches that end on their first turn, on a middle turn and at their
  trip, the turns each loop ran counted by the gate.
- The driver hands the gate one turn per search loop, the same turn
  whatever the caps.
- A solve in blocks whose searches run on the gated driver, against the
  JAX package on the searches of
  ``tests/test_torch_direct.py::test_f64_direct_trajectory_matches_jax``,
  under that test's tolerances.
- The launch counts of a gated body folded from its tally and its turns.
"""
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_lbfgs as tl
import tpu_lbfgs_torch as tt
from test_torch_batch_search_loops import _cubics, _phis, _polys
from test_torch_direct import (
    D,
    INTERPOLATING,
    ITERS,
    _direct,
    _follow_jax,
    _jax_stepper,
    _rel,
    _torch_solver,
)
from tpu_lbfgs_torch.core import blocks, solver
from tpu_lbfgs_torch.kernels import counts
from tpu_lbfgs_torch.linesearch import strategies as ls

torch.set_num_threads(1)

STRATEGIES = list(tt.config.LINE_SEARCH_METHODS)
DTYPES = {"f32": torch.float32, "f64": torch.float64}


class CountingGate(ls.EagerGate):
    """The eager gate, recording the turns each gated loop ran."""

    def __init__(self):
        self.loops = []

    def loop(self, pred, turn):
        assert pred.dtype == torch.bool and pred.dim() == 0
        self.loops.append(0)

        def counted():
            self.loops[-1] += 1
            turn()

        super().loop(pred, counted)


def _run(strategy, cfg, coeffs, driver):
    """One search over the lanes of ``coeffs`` on ``driver``: "read",
    "fixed" or "gated" (the eager gate); its result and host reads."""
    phi, phi_dphi = _phis(coeffs)
    ls.reset_host_reads()
    search = ls.get_line_search(strategy)
    args = (cfg, phi, phi_dphi, coeffs[..., 0], coeffs[..., 1])
    if driver == "gated":
        gate = CountingGate()
        with ls.gated(gate):
            out = search(*args)
        return out, ls.host_reads["line_search"], gate
    return search(*args, bounded=driver == "fixed"), \
        ls.host_reads["line_search"], None


def _assert_same(a, b, what):
    for field in ("alpha", "n_fev", "n_gev", "rescued"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.shape == y.shape and x.dtype == y.dtype, (what, field)
        assert torch.equal(x, y), (what, field)


@pytest.mark.parametrize("fidelity", ["reference", "fixed"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_gated_driver_equals_the_other_two(strategy, batched, dtype,
                                           fidelity):
    """The gated driver equals the read-driven and fixed-trip drivers bit
    for bit, on the float32 cubics and the float64 polynomials of
    ``tests/test_torch_batch_search_loops.py`` (cast to the dtype), as one
    batch whose lanes end on different turns and row by row, under both
    fidelities (under "fixed" armijo_interpolation's body hands back its
    carry's alpha as the next alpha_prev); it reads nothing on the host
    (the eager gate's own read is not a search's)."""
    cfg = tt.LBFGSConfig(line_search=strategy, c2=0.9, fidelity=fidelity)
    for name, make in (("cubics", _cubics), ("polys", _polys)):
        coeffs = torch.from_numpy(make()).to(DTYPES[dtype])
        cases = [coeffs] if batched else list(coeffs)
        for i, c in enumerate(cases):
            read, _, _ = _run(strategy, cfg, c, "read")
            fixed, _, _ = _run(strategy, cfg, c, "fixed")
            gated, reads, gate = _run(strategy, cfg, c, "gated")
            _assert_same(read, gated, (name, i, "read"))
            _assert_same(fixed, gated, (name, i, "fixed"))
            assert reads == 0, (name, i)
            if not (strategy == "backtracking" and batched):
                assert gate.loops, (name, i)    # the search looped


# Lanes of phi(a) = c0 + c1 a + c2 a^2 and the caps under which a search
# on them ends on its first turn (a = 1 is phi's minimizer), on a middle
# turn (the minimizer is a = 0.01), or at its trip (a step below 1e-6 is
# needed and the caps are 3).
ENDS = {"first": ([0.0, -1.0, 0.5], None),
        "middle": ([0.0, -1.0, 50.0], None),
        "trip": ([0.0, -1e-3, 1e3], 3)}


@pytest.mark.parametrize("end", list(ENDS))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_gated_driver_ends(strategy, end, monkeypatch):
    """One instance whose search ends on its first turn, on a middle turn
    or at its trip bound: the three drivers agree bit for bit, and the
    turns of each gated loop (counted by the gate, plus the first turn
    that ``enter`` runs with no gate) are 1, between 1 and the trip, or
    the trip.  Twins speculate 2 trials a round (spec_width = 2)."""
    row, cap = ENDS[end]
    cfg = tt.LBFGSConfig(line_search=strategy, c2=0.9, spec_width=2)
    if cap is not None:
        # backtracking_tol ends the Armijo ladders before an accepted step.
        # The bracketing twin's two phases share one cap: with 4 trials a
        # round (> cap) its bracketing phase runs its whole trip, one round.
        cfg = cfg.replace(ls_max_iters=cap, ls_safety_cap=cap,
                          backtracking_tol=1e-4,
                          spec_width=4 if strategy ==
                          "wolfe_interpolation_speculative" else 2)
    coeffs = torch.tensor(row + [0.0, 0.0], dtype=torch.float64)
    seen = []
    inner = ls._loop

    def record(cond, body, carry, trips, bounded, enter=None):
        if ls._GATE is not None:
            seen.append((trips, enter))
        return inner(cond, body, carry, trips, bounded, enter)

    monkeypatch.setattr(ls, "_loop", record)
    read, _, _ = _run(strategy, cfg, coeffs, "read")
    fixed, _, _ = _run(strategy, cfg, coeffs, "fixed")
    gated, reads, gate = _run(strategy, cfg, coeffs, "gated")
    _assert_same(read, gated, "read")
    _assert_same(fixed, gated, "fixed")
    assert reads == 0
    # Loops that ran no turn (a phase B the bracket never entered) aside.
    loops = [(trips, turns + (enter is True))
             for (trips, enter), turns in zip(seen, gate.loops)
             if turns + (enter is True)]
    assert loops, seen
    if end == "first":
        assert all(turns == 1 for _, turns in loops), loops
    elif end == "middle":
        assert any(1 < turns < trips for trips, turns in loops), loops
    else:
        assert any(turns == trips for trips, turns in loops), loops


@pytest.mark.parametrize("enter", [None, True, False])
@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_gated_driver_enter(enter, batched):
    """``enter``: False runs no turn, True runs the first turn with no
    gate, None gates the first turn too; the loop ends where the
    read-driven driver's does, lanes frozen as they end.  A countdown per
    lane: cond = n > 0, body = n - 1, with a turn counter."""
    start = torch.tensor([3, 0, 5, 1] if batched else 3, dtype=torch.int32)

    def cond(c):
        return c[0] > 0

    def body(c):
        return c[0] - 1, c[1] + 1

    carry = (start, torch.zeros_like(start))
    want = ls._loop(cond, body, carry, 8, False, enter)
    gate = CountingGate()
    with ls.gated(gate):
        got = ls._loop(cond, body, carry, 8, False, enter)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    if enter is False:
        assert got is carry and not gate.loops
    else:
        gated_turns = int(start.max()) - (enter is True)
        assert gate.loops == [gated_turns]
        assert got[0] is not carry[0]       # the buffers, not the carry


# --- a solve in blocks on the gated driver against the JAX package ---------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_gated_blocks_match_jax(strategy, monkeypatch):
    """A float64 direct-mode solve in blocks (one-iteration blocks, the
    gated runner's) with every search on the gated driver, against the JAX
    package under the tolerances of test_f64_direct_trajectory_matches_jax.
    A search whose alpha comes from an exact ladder: the whole solve,
    ``solve_from_state`` from x0 in both packages, every counter and alpha
    equal, f and ||g|| within 1e-9 or 100x the JAX package's own deviation
    from x0 moved by one ulp on every seventh coordinate.  An
    interpolating search: each iteration a one-iteration segment from the
    JAX package's state, alpha, f and ||g|| to that test's step bounds
    (``_follow_jax``).  No search reads the host."""
    cfg_j = _direct(tl, line_search=strategy)
    cfg_t = _direct(tt, line_search=strategy)
    s = _torch_solver()
    x0 = -1.2 + np.random.default_rng(7).uniform(-0.1, 0.1, D)
    # Every solve in blocks, its searches on the gated driver through the
    # eager gate: what a captured block does on the card, with no graph.
    monkeypatch.setattr(solver, "_blocked", lambda *a, **k: True)
    with ls.gated(ls.EagerGate()):
        ls.reset_host_reads()
        blocks.reset_stats()
        if strategy in INTERPOLATING:
            seg = tt.make_solve_segment(
                cfg_t.replace(max_iters=ITERS), s["f"],
                value_and_grad=s["vg"], iters=1, fused_tail=s["fused_tail"],
                phi_batch=s["phi_batch"], phi_dphi_batch=s["phi_dphi_batch"])
            _follow_jax(cfg_j, _jax_stepper(cfg_j), seg, x0, ITERS // 2)
            assert blocks.stats["steps"] == ITERS // 2
        else:
            cfg = cfg_t.replace(max_iters=ITERS, tol=0.0)
            got = tt.solve_from_state(
                cfg, s["f"], s["vg"],
                tt.init_state(s["vg"], torch.from_numpy(x0), cfg.m), None,
                s["fused_tail"], s["phi_batch"], s["phi_dphi_batch"])
            assert blocks.stats["steps"] == ITERS
            _assert_free_solve_matches_jax(cfg_j.replace(
                max_iters=ITERS, tol=0.0), got, x0)
        assert ls.host_reads["line_search"] == 0


def _assert_free_solve_matches_jax(cfg_j, got, x0):
    p = tl.get_problem("rosenbrock")
    vg = tl.fused_value_and_grad("rosenbrock", use_pallas=True)
    tail = tl.fused_tail_for("rosenbrock", with_matvec=False, use_pallas=True)
    solve = jax.jit(lambda s: tl.solve_from_state(cfg_j, p.f, vg, s, None,
                                                  tail))
    x1 = x0.copy()
    x1[::7] = np.nextafter(x1[::7], np.inf)
    sj = solve(tl.init_state(vg, jnp.asarray(x0), cfg_j.m))
    sp = solve(tl.init_state(vg, jnp.asarray(x1), cfg_j.m))
    for name in ("status", "k", "n_pairs", "n_fev", "n_gev", "guards",
                 "alpha"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(sj, name)),
                                      err_msg=name)
    for name in ("f", "g_norm"):
        ref = float(getattr(sj, name))
        bound = max(1e-9, 100 * _rel(ref, float(getattr(sp, name))))
        assert _rel(ref, getattr(got, name).item()) <= bound, name


# --- launch counts through a gated body -------------------------------------

def test_gated_body_counts_fold_tally_times_turns():
    """A gated loop's first turn records its launches in a tally of its
    own; ``fold`` adds tally x the turns its counter shows since the last
    fold to ``launch_counts()`` and ``replay_counts()`` and the turns to
    the stats' "gated_turns", and drops a capture whose owner is gone."""

    class Owner:
        pass

    tt.kernels.reset_launches()
    name = "rosenbrock_multi_phi"
    owner, sink = Owner(), {"gated_turns": 0}
    turns = torch.zeros(3, dtype=torch.int64)
    with counts.recording() as tally:
        counts.count(tt.kernels.line_search_ops.launches, name)
        counts.count(tt.kernels.line_search_ops.launches, name)
    assert tally == Counter({name: 2})
    counts.gated(owner, turns, [(1, tally)], sink)
    turns[1] = 5
    assert tt.kernels.launch_counts()[name] == 10
    assert tt.kernels.replay_counts()[name] == 10 and sink["gated_turns"] == 5
    turns[1] = 7
    counts.fold()
    assert tt.kernels.launch_counts()[name] == 14 and sink["gated_turns"] == 7
    del owner
    turns[1] = 8
    counts.fold()
    assert tt.kernels.launch_counts()[name] == 16
    assert not counts._gated        # folded once more, then dropped
    tt.kernels.reset_launches()
    assert not any(tt.kernels.launch_counts().values())


def test_gated_captures_of_gone_runners_stay_bounded():
    """A program that solves in a loop, capturing anew each time, registers
    a capture per solve: those whose runner is gone are merged as new ones
    come (one counter per distinct tally), so the registry stays small and
    the folded counts are those of every capture."""

    class Owner:
        pass

    tt.kernels.reset_launches()
    name = "rosenbrock_multi_phi"
    sink = {"gated_turns": 0}
    tallies = []
    for per_turn in (1, 3):
        with counts.recording() as tally:
            for _ in range(per_turn):
                counts.count(tt.kernels.line_search_ops.launches, name)
        tallies.append(tally)
    want_launches = want_turns = 0
    for solve in range(100):
        owner = Owner()
        turns = torch.zeros(4, dtype=torch.int64)
        loops = [(0, tallies[solve % 2]), (2, tallies[1])]
        counts.gated(owner, turns, loops, sink)
        turns[0], turns[2] = solve, 2
        want_turns += solve + 2
        want_launches += solve * (1 + 2 * (solve % 2)) + 2 * 3
        if solve == 50:
            counts.fold()           # a fold in between is not counted twice
        del owner
        assert len(counts._gated) <= 3, solve
    assert tt.kernels.launch_counts()[name] == want_launches
    assert sink["gated_turns"] == want_turns
    assert len(counts._gated) == 1          # the merged captures
    tt.kernels.reset_launches()
    assert not any(tt.kernels.launch_counts().values())


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
def test_gated_driver_copies_a_view_of_its_carry(batched):
    """A body that hands back a view of one of its carry's tensors in
    another slot (the next b is this turn's a, as a view): the gated driver
    copies it before it overwrites its buffers, so it equals the
    read-driven and fixed-trip drivers."""
    shape = (3,) if batched else ()
    carry = (torch.zeros(shape, dtype=torch.float64),
             torch.full(shape, -1.0, dtype=torch.float64))
    limit = torch.tensor([2.0, 4.0, 5.0][:3 if batched else 1],
                         dtype=torch.float64).reshape(shape)

    def cond(c):
        return c[0] < limit

    def body(c):
        return c[0] + 1.0, c[0][...]

    want = ls._loop(cond, body, carry, 8, bounded=False)
    fixed = ls._loop(cond, body, carry, 8, bounded=True)
    with ls.gated(ls.EagerGate()):
        got = ls._loop(cond, body, carry, 8, bounded=False)
    for w, f, g in zip(want, fixed, got):
        assert torch.equal(w, g) and torch.equal(f, g)
    assert torch.equal(got[1], got[0] - 1.0)


# --- one turn per search loop ------------------------------------------------

class RecordingGate:
    """A gate that runs each loop's turn once, as a capture records it, and
    counts the trials the turn evaluates."""

    def __init__(self, trials):
        self.trials, self.turns = trials, []

    def loop(self, pred, turn):
        assert pred.dtype == torch.bool and pred.dim() == 0
        before = sum(self.trials.values())
        turn()
        self.turns.append(sum(self.trials.values()) - before)


# Search loops a search hands its gate: the bracketing twin's two phases.
LOOPS = {"wolfe_interpolation_speculative": 2}


@pytest.mark.parametrize("batched", [False, True], ids=["one", "batch"])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_gated_driver_hands_one_turn_per_loop(strategy, batched):
    """Each search hands the gate exactly one turn per loop, one trial (a
    round of K for a twin) each, under the default caps and under
    ls_safety_cap and ls_max_iters times 4: what a WHILE node captures does
    not grow with the trip bound (backtracking on a batch takes its whole
    ladder at once and loops not at all)."""
    coeffs = torch.from_numpy(_polys())
    coeffs = coeffs if batched else coeffs[0]
    cfg = tt.LBFGSConfig(line_search=strategy, c2=0.9)
    seen = []
    for c in (cfg, cfg.replace(ls_safety_cap=4 * cfg.ls_safety_cap,
                               ls_max_iters=4 * cfg.ls_max_iters)):
        phi, phi_dphi = _phis(coeffs)
        trials = Counter()

        def count(fn, name):
            def counted(alpha):
                trials[name] += 1
                return fn(alpha)
            return counted

        gate = RecordingGate(trials)
        with ls.gated(gate):
            ls.get_line_search(strategy)(
                c, count(phi, "phi"), count(phi_dphi, "phi_dphi"),
                coeffs[..., 0], coeffs[..., 1])
        seen.append(gate.turns)
    loops = 0 if strategy == "backtracking" and batched \
        else LOOPS.get(strategy, 1)
    assert seen[0] == seen[1] == [1] * loops, seen


@pytest.mark.parametrize("enter", [None, True])
def test_gated_driver_keeps_a_finished_lanes_carry(enter):
    """A batch whose lanes' conditions turn false on different turns of the
    loop: a lane that has ended keeps its carry while the others go on (a
    body applied to it would drive its count below 0 and add to its sum),
    as under the read-driven and fixed-trip drivers."""
    start = torch.tensor([2, 5, 1, 3], dtype=torch.int32)

    def cond(c):
        return c[0] > 0

    def body(c):
        return c[0] - 1, c[1] + 10.0 * c[0].to(torch.float64)

    carry = (start, torch.zeros(4, dtype=torch.float64))
    gate = CountingGate()
    with ls.gated(gate):
        got = ls._loop(cond, body, carry, 8, False, enter)
    assert torch.equal(got[0], torch.zeros(4, dtype=torch.int32))
    # n + (n - 1) + ... + 1, times 10, on every lane.
    want_sum = (start * (start + 1) * 5).to(torch.float64)
    assert torch.equal(got[1], want_sum)
    for bounded in (False, True):
        other = ls._loop(cond, body, carry, 8, bounded, enter)
        assert all(torch.equal(a, b) for a, b in zip(other, got)), bounded
    assert gate.loops == [int(start.max()) - (enter is True)]
