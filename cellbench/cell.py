"""One run of one cell: set-up, the measured window, the traced slice and
the comparison, on one device.

The program under test is ``tpu_lbfgs_torch``, driven only through its
public functions.  A cell's configuration and traffic mix say what it
solves; a request is one solve, and the window runs one after another,
closed loop, for ``--seconds``:

- ``"drive": "while"`` (one instance, ``batch`` null): ``init_state`` and
  ``solve_from_state`` with the cell's fused callables and one
  ``blocks.Kept`` runner for every solve, as the program's own harness
  drives it (``bench/harness.py::_solve``);
- ``"drive": "bounded"`` (a batch of ``batch`` lanes): ``init_state`` over
  a (batch, d) start and ``solve_bounded``, with a kept runner too.

A solve ends when its x, f, ||g||, k, status and counts can be read on the
host: one read of its scalars (for a batch, of their sums) after it.  Its
start is the next row of a pool drawn on the device from the seed during
set-up.  Set-up ends with one solve from a start of its own, which builds
or loads the kernels and captures the runner's graphs.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time

import torch

from . import check
from .reference import lbfgs as reference

#: Rows of the pool drawn per call of the generator.
_DRAW_ROWS = 16
#: The numbers of ``check.end_state`` that a run reads.
NUMBERS = ("f_at_x", "g_at_x", "ring_gap", "secant_gap", "armijo_gap",
           "curvature_gap")
#: The state's fields the comparison reads, beside its ring.
_KEPT = ("x", "f", "g", "g_norm", "k", "n_fev", "alpha", "n_pairs")


def span(name: str):
    """A host span named ``cellbench.<name>`` in a profiled slice."""
    from torch.profiler import record_function
    return record_function(f"cellbench.{name}")


class Program:
    """The cell's solve on the program under test, built from its
    configuration and traffic mix, with one kept block runner."""

    def __init__(self, cell, device: torch.device):
        import tpu_lbfgs_torch as tt
        from tpu_lbfgs_torch.core import blocks

        self.tt, self.blocks = tt, blocks
        conf, traffic = cell.config, cell.traffic
        self.settings = cell.settings()
        self.budget = traffic["iters"]
        self.batch, self.d = conf["batch"], conf["d"]
        self.dtype = getattr(torch, conf["dtype"])
        self.itemsize = torch.empty((), dtype=self.dtype).element_size()
        self.device = device
        self.cfg = tt.LBFGSConfig(max_iters=self.budget, **self.settings)
        problem = conf["problem"]
        self.p = tt.get_problem(problem)
        self.vg = tt.fused_value_and_grad(problem)
        lanes = self.batch or 1
        self.tail = tt.fused_tail_for(problem, with_matvec=conf["with_matvec"],
                                      m=self.cfg.m, d=self.d, batch=lanes)
        self.tail_products = conf["with_matvec"] is True or (
            conf["with_matvec"] == "auto"
            and tt.auto_with_matvec(self.cfg.m, self.d, batch=lanes))
        direct = self.cfg.ls_eval == "direct"
        self.phi_batch = tt.multi_phi_for(problem) \
            if direct and self.cfg.line_search == "backtracking_speculative" \
            else None
        self.phi_dphi_batch = tt.multi_phi_dphi_for(problem) \
            if direct and self.cfg.line_search in (
                "wolfe_interpolation_speculative",
                "backtracking_wolfe_speculative") else None
        self.dir_poly = self.p.dir_poly if not direct else None
        self.bounded = traffic["drive"] == "bounded"
        self.kept = blocks.Kept()

    def solve(self, x0: torch.Tensor, iters: int | None = None):
        """The timed path: one solve from ``x0`` with the kept runner;
        returns the state (the kept buffers, which the next solve
        overwrites).  With ``iters``, a solve of that many iterations by
        the same entry with no kept runner, as a caller's short solve runs
        (a budget under the one that captures graphs)."""
        tt = self.tt
        cfg = self.cfg if iters is None else self.cfg.replace(max_iters=iters)
        with span("init_state"):
            state = tt.init_state(self.vg, x0, cfg.m)
        run = tt.solve_bounded if self.bounded else tt.solve_from_state
        with span("solve"):
            return run(cfg, self.p.f, self.vg, state, self.dir_poly,
                       self.tail, self.phi_batch, self.phi_dphi_batch,
                       kept=self.kept if iters is None else None)

    def keep(self, state, into=None):
        """A copy of the solve's state, out of the kept buffers that the
        next solve overwrites (into ``into``'s tensors when given, so that
        a kept solve costs its copies and no allocation)."""
        if into is None:
            return state.replace(**{f.name: getattr(state, f.name).clone()
                                    for f in dataclasses.fields(state)})
        for f in dataclasses.fields(state):
            getattr(into, f.name).copy_(getattr(state, f.name))
        return into

    def result(self, state) -> dict:
        """A kept solve in the reference's format (``check``), the ring
        with its newest pair last: row i is slot (n_pairs - m + i) mod m."""
        tt = self.tt
        m = state.s_hist.shape[-2]
        n = state.n_pairs.long()
        order = (n.unsqueeze(-1) - m + torch.arange(m, device=n.device)) % m
        idx = order.unsqueeze(-1).expand(*order.shape, state.x.shape[-1])
        guards = state.guards.long()
        status = state.status.tolist()
        out = {name: getattr(state, name) for name in _KEPT}
        out.update(
            s_rows=torch.gather(state.s_hist, -2, idx),
            y_rows=torch.gather(state.y_hist, -2, idx),
            status=(tt.Status.NAMES[status] if isinstance(status, int)
                    else [tt.Status.NAMES[s] for s in status]),
            rejects=guards[..., tt.Guard.PAIR_REJECT],
            fallbacks=(guards[..., tt.Guard.DIR_FALLBACK]
                       + guards[..., tt.Guard.NOT_DESCENT]),
            failed=guards[..., tt.Guard.LANE_FREEZE])
        return out

    def next_direction(self, state):
        """The direction of one more iteration from a kept solve's final
        state, run by the timed entry and its kept runner (its graphs read
        the budget from the device), as s / alpha of the pair it stores;
        None where its search failed or it stored no pair."""
        tt = self.tt
        k, n = int(state.k), int(state.n_pairs)
        cfg = self.cfg.replace(max_iters=k + 1)
        start = self.keep(state).replace(
            status=torch.full_like(state.status, tt.Status.RUNNING))
        out = tt.solve_from_state(cfg, self.p.f, self.vg, start,
                                  self.dir_poly, self.tail, self.phi_batch,
                                  self.phi_dphi_batch, kept=self.kept)
        if int(out.k) != k + 1 or int(out.n_pairs) != n + 1 \
                or not bool(out.alpha > 0):
            return None
        m = out.s_hist.shape[-2]
        return out.s_hist[n % m].double() / out.alpha.double()

    def summary(self, state) -> torch.Tensor:
        """What the host reads to end a solve, as one float64 tensor: the
        sums over the lanes of k and n_fev, the lanes that ran their
        budget, the lanes with a finite f, and f and ||g|| of lane 0."""
        ran = state.status == self.tt.Status.MAX_ITERS
        return torch.stack([
            state.k.sum().double(), state.n_fev.sum().double(),
            ran.sum().double(), torch.isfinite(state.f).sum().double(),
            state.f.reshape(-1)[0].double(),
            state.g_norm.reshape(-1)[0].double()]).cpu()


def draw_pool(seed: int, rows: int, shape: tuple, box: float, dtype,
              device) -> torch.Tensor:
    """``rows`` starting points U(-box, box) of ``shape``, drawn in float64
    on ``device`` from ``seed`` and rounded to ``dtype``: the rule of the
    program's ``bench/harness.py::_x0`` (U(-2, 2) in float64, rounded),
    drawn by a generator on the device."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2 ** 64 - 1))
    pool = torch.empty((rows,) + shape, dtype=dtype, device=device)
    for i in range(0, rows, _DRAW_ROWS):
        n = min(_DRAW_ROWS, rows - i)
        u = torch.rand((n,) + shape, dtype=torch.float64, generator=gen,
                       device=device)
        pool[i:i + n] = (u * (2.0 * box) - box).to(dtype)
    return pool


class Run:
    """One run of ``cell`` with ``seed`` on ``device``; ``t_start`` is the
    host clock at the process's start, from which set-up is counted."""

    def __init__(self, cell, seed: int, seconds: float, device: torch.device,
                 t_start: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.device, self.t_start = device, t_start
        self.numbers, self.slice = {}, None
        self.walls, self.iterations, self.fevs, self.solves = [], 0, 0, 0
        self.failed = 0
        self.checked = []

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        """Everything before the window; ``setup_parts`` holds the host
        clock, from the process's start, at the end of each part."""
        cell, traffic = self.cell, self.cell.traffic
        parts = self.setup_parts = {
            "imports": time.perf_counter() - self.t_start}
        self.program = prog = Program(cell, self.device)
        shape = ((prog.batch,) if prog.batch else ()) + (prog.d,)
        self.pool = draw_pool(self.seed, traffic["pool"] + 1, shape,
                              traffic["box"], prog.dtype, self.device)
        self._sync()
        parts["program and pool"] = time.perf_counter() - self.t_start
        rng = random.Random(self.seed)
        self.sample = set(rng.sample(range(traffic["check_from"]),
                                     traffic["check_solves"]))
        before = dict(prog.blocks.stats)
        state = prog.solve(self.pool[-1])               # builds and captures
        prog.summary(state)
        self.buffers = [prog.keep(state) for _ in self.sample]
        self.capture_s = prog.blocks.stats["capture_s"] - before["capture_s"]
        self._sync()
        self.setup_s = time.perf_counter() - self.t_start

    def _one(self, i: int) -> None:
        prog = self.program
        t0 = time.perf_counter()
        state = prog.solve(self.pool[i % (len(self.pool) - 1)])
        if i in self.sample:
            with span("keep"):
                self.checked.append(prog.keep(state, self.buffers.pop()))
        with span("read"):
            k, fev, ran, finite, _, _ = prog.summary(state).tolist()
        self.walls.append(time.perf_counter() - t0)
        self.iterations += int(k)
        self.fevs += int(fev)
        lanes = prog.batch or 1
        self.failed += int(finite < lanes)
        self.solves += 1

    def window(self) -> None:
        """Solves one after another until ``seconds`` have passed."""
        prog = self.program
        self.reads0 = prog.blocks.stats["host_reads"]
        t0 = time.perf_counter()
        while True:
            self._one(self.solves)
            self.window_s = time.perf_counter() - t0
            if self.window_s >= self.seconds:
                break
        self.host_reads = prog.blocks.stats["host_reads"] - self.reads0
        self.window_iterations = self.iterations
        self.window_solves = self.solves
        self.window_steps = self._steps(self.window_solves,
                                        self.window_iterations)

    def traced_slice(self) -> None:
        """``trace_solves`` more solves, profiled (``trace.profiled``)."""
        from .trace import profiled

        n, first = self.cell.traffic["trace_solves"], self.solves
        it0 = self.iterations

        def solves():
            for i in range(first, first + n):
                self._one(i)

        _, self.slice = profiled(solves)
        self.slice_steps = self._steps(n, self.iterations - it0)

    def _steps(self, solves: int, iterations: int) -> int:
        """Lockstep iterations: a batch steps its budget whatever its lanes
        do; one instance steps its own k."""
        prog = self.program
        return solves * prog.budget if prog.batch else iterations

    def memory(self) -> int:
        return (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)

    # --- the comparison ---------------------------------------------------

    def compare(self) -> None:
        """The numbers of ``check`` over the kept solves, once the window
        has closed: the kept runner first takes one more step from each
        kept solve's state, then it and the pool are freed."""
        cell, prog = self.cell, self.program
        settings = prog.settings
        starts = [self.pool[i % (len(self.pool) - 1)].clone()
                  for i in sorted(self.sample)][:len(self.checked)]
        checked = [prog.result(state) for state in self.checked]
        del self.pool
        nexts = [] if prog.bounded else [prog.next_direction(state)
                                         for state in self.checked]
        prog.kept = None
        first = cell.traffic["start_iters"]
        firsts = [prog.solve(x0, first).x.clone() for x0 in starts] \
            if first else []
        numbers = {n: [] for n in NUMBERS}
        short = 0
        for res in checked:
            per = check.end_state(res, settings, prog.budget)
            for name in numbers:
                numbers[name].append(per[name])
            short += int(per["short"].sum())
        self.numbers = {n: check.largest(v) for n, v in numbers.items()}
        self.numbers["short"] = float(short)
        if prog.batch:
            # The whole budget by the reference in float64.
            gaps = []
            for x0, res in zip(starts, checked):
                ref = reference.solve(x0, settings, prog.budget,
                                      torch.float64)
                gaps.append(check.f_gap_median(res["f"], ref["f"]))
            self.numbers["f_gap_median"] = max(gaps) if gaps else math.nan
        else:
            gaps = [check.direction_gap(d, res, settings)
                    for d, res in zip(nexts, checked) if d is not None]
            self.numbers["direction_gap"] = max(gaps) if gaps else math.nan
            gaps = []
            for x0, x in zip(starts, firsts):
                ref = reference.solve(x0, settings, first, prog.dtype)
                gaps.append(check.x_gap(x, ref["x"]))
            self.numbers["start_gap"] = max(gaps) if gaps else math.nan
        if not self.checked:
            self.numbers = {}
