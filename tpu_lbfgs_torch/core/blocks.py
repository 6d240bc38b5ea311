"""The solve loops as blocks of iterations on the device, the counterpart
of the reference's ``lax.while_loop`` / ``lax.fori_loop`` solves
(``tpu_lbfgs/core/solver.py:559-682``).

A block is ``n`` iterations of one solve.  Under the while forms
(``solve_from_state``, ``make_solve_segment``) each iteration computes the
loop condition on the device, ``_running`` and the segment's cap
``k < k_cap``, and hands it to ``iterate`` as its ``lanes`` mask, so a lane
whose condition fails inside a block stays frozen there, as under the
reference's ``while_loop``; the fixed-budget form (``solve_bounded``, a
``fori_loop`` in the reference) steps with no mask.  A block ends by
writing the state back into the solve's own buffers and the loop's flags
into a small tensor: the host reads that once per block, where the eager
loop reads the condition once per iteration.  ``solve_bounded`` reads
nothing.

On a CUDA device a ``BlockRunner`` captures each block length it runs once
as a ``torch.cuda.CUDAGraph`` and replays it: ``BLOCK_ITERS`` iterations,
and one iteration for the rest of a budget that ``BLOCK_ITERS`` does not
divide; ``refresh_products`` at a segment's edge is a graph of its own.
On the CPU, and on the card inside ``eager_loops()`` (the counterpart of
``jax.disable_jit()``), the same blocks run eagerly: the device-side
mask, the freeze, one read per block, no capture.  A capture or replay
that fails raises, naming the solve's callables; nothing carries on
eagerly by itself.  The solver keeps its per-iteration loop
(``solver._run_segment``) for a sharded solve (``comm``; gloo's
collectives go through the host) and under ``set_debug_nans(True)`` (it
reads by design).

A line search that loops (``strategies.reads_on_host``) runs, while a
block is captured, on the gated driver: each of its loops one CUDA graph
WHILE node on "a lane still searches" whose body is the loop's one turn
(``kernels.graph_if``), so a replay runs the turn while the search runs
and reads nothing, as the reference's ``while_loop`` does.  Such a
runner captures one-iteration blocks (``GATED_BLOCK_ITERS``) and
replays them up to ``BLOCK_ITERS`` times between reads; its warm-up runs
each search loop's turn once.  Its eager blocks would read once per
turn, as the per-iteration loop does, so a while form of such a search
runs in blocks only where they are captured (``solver._blocked``);
``solve_bounded``'s eager blocks run the fixed trip.  ``solve_traced`` is the traced solve's loop: each iteration
also writes its row of the trace into a buffer on the device.

Buffers.  A graph reads and writes fixed addresses, so a runner owns the
state it iterates: a copy of every field of the state handed in but the
ring, whose rows ``iterate`` writes in place as it always did (the state
handed in gives its ring to the solve).  So a solve holds no second ring,
at d = 1e8 and m = 10 8 GB.  The warm-up before the first capture
iterates with every lane masked off, which runs every kernel and leaves
the state as it was.  Each runner's graphs share one private memory pool,
which holds a block's temporaries, a WHILE body's included, for as long as
the runner lives.  The flags come to the host through a pinned buffer
and an event, so ``torch.cuda.set_sync_debug_mode("error")`` lets the
loop's own read through and catches any other.

A solve captures only when its budget, the most iterations its arguments
let it run, is at least ``CAPTURE_MIN_ITERS``, or
``GATED_CAPTURE_MIN_ITERS`` where its search loops (``captures``):
below that, a capture costs more than the eager blocks or the
per-iteration loop it would replace, as measured on the card (the
constants' comments; PERF.md).  A solve makes its
runner and drops it at its end, so each call captures anew, as a solve
that is not kept would compile anew.  A caller that runs many solves of
one configuration keeps one runner in a ``Kept`` and hands it to each
(``make_solve_segment``'s segment function and the harnesses do): a kept
runner copies each new state into its buffers and returns them, so the
state it returned before is overwritten, as the reference's donated
buffers are (a segment function under ``donate=False`` returns a copy).
"""
from __future__ import annotations

import dataclasses
import time
from collections import Counter
from contextlib import contextmanager
from typing import Callable, Optional

import torch

from ..kernels import chain, counts, graph_if
from ..linesearch import strategies
from ..types import LBFGSState, Status, Trace
from . import solver

#: Iterations per captured block, and between two host reads of the
#: flags.  A solve that ends inside a block replays up to BLOCK_ITERS - 1
#: frozen iterations.
BLOCK_ITERS = 20
#: The least budget of a solve that captures its blocks (module docstring):
#: a capture costs about one eager solve of 20-40 iterations on bench.py's
#: path (``torch_records/graph_costs.py``, NVIDIA H100 80GB HBM3, 700 W).
CAPTURE_MIN_ITERS = 2 * BLOCK_ITERS
#: The same for a solve whose line search loops (the gated driver): the
#: expected break-even of a one-iteration block's capture on one instance
#: at d = 2^20, its mean seconds (0.145, warm-up included) over the mean
#: it saves an iteration against the per-iteration loop (4.77 ms), is
#: 30.4 iterations; 27 of 32 such captures of the 7 looping searches broke
#: even within 30 (median 10.4), the batch cell's 52 of 56 (expected 2.7)
#: (``graph_costs.py --gated``, two runs, same card).
GATED_CAPTURE_MIN_ITERS = 30
#: Iterations per captured block of a solve whose line search loops (the
#: gated driver: each loop a WHILE node), replayed up to BLOCK_ITERS times
#: between reads.  On one instance at d = 2^20 blocks of 20 replay 2.4-7.0%
#: faster, but their capture (median 0.18-0.48 s a search against
#: 0.04-0.11 s) pays for itself only after 1,200-10,000 iterations; on the
#: batch cell they gain nothing (the same runs as above).
GATED_BLOCK_ITERS = 1

#: Blocks since the last ``reset_stats()``: graphs captured and the host
#: seconds they took (warm-up included), the warm-ups' share of those
#: seconds, warm-up iterations, replays, iterations stepped on the device
#: (frozen ones included, eager or replayed), host reads of the loop's
#: flags, the nodes captured other than WHILE nodes (kernels and copies,
#: every WHILE body's included), the WHILE nodes captured (one per gated
#: search loop), the gated line-search turns the replays ran
#: ("gated_turns", counted on the device and brought up to date by
#: ``kernels.launch_counts()`` or ``read_stats()``), and the kernel
#: launches of the warm-ups by wrapper (counted in ``launch_counts()``
#: too: the card ran them).
stats = {"captures": 0, "capture_s": 0.0, "warmup_s": 0.0, "warmups": 0,
         "replays": 0, "steps": 0, "host_reads": 0, "graph_nodes": 0,
         "while_nodes": 0, "gated_turns": 0, "warmup_launches": Counter()}

_EAGER = False

_RING = ("s_hist", "y_hist")
_FIELDS = tuple(f.name for f in dataclasses.fields(LBFGSState))
_TRACE = Trace._fields


def reset_stats() -> None:
    counts.fold()
    for name in stats:
        stats[name] = type(stats[name])()


def read_stats() -> dict:
    """``stats`` with the gated turns run brought up to date (a host read
    of their counters): outside a solve."""
    counts.fold()
    return stats


@contextmanager
def eager_loops():
    """Run the solve loops' blocks eagerly on the card, with no CUDA
    graph: the counterpart of ``jax.disable_jit()``, for debugging and for
    holding a replayed run to the eager one."""
    global _EAGER
    outer, _EAGER = _EAGER, True
    try:
        yield
    finally:
        _EAGER = outer


def _meta(state: LBFGSState) -> tuple:
    return tuple((t.shape, t.dtype, t.device)
                 for t in (getattr(state, n) for n in _FIELDS))


def _copy_into(dst: LBFGSState, src: LBFGSState) -> None:
    for name in _FIELDS:
        a, b = getattr(dst, name), getattr(src, name)
        if a is not b:
            a.copy_(b)


def _name(fn) -> str:
    return getattr(fn, "__qualname__", type(fn).__name__)


class BlockRunner:
    """The blocks of one solve on its own buffers ``s``.

    ``masked``: the while forms (each iteration masked by the loop
    condition; flags written for the host); else the fixed-budget form.
    ``interval``: the refresh interval, which caps the budget of the next
    segment in the flags.  ``callables``: the solve's callables by name,
    for the capture's error message.  ``graphed``: whether the blocks are
    captured and replayed; by default on a CUDA device outside
    ``eager_loops()``.  ``gated``: the line search loops, so a capture
    runs it on the gated driver (``kernels.graph_if``) and a captured
    block is ``GATED_BLOCK_ITERS`` iterations, else ``BLOCK_ITERS``
    (``block``).
    ``rows``: the traced solve's ``max_iters``: each iteration also writes
    its row of the trace at a step counter on the device (``trace``)."""

    def __init__(self, cfg, step: Callable, state: LBFGSState, masked: bool,
                 interval: Optional[int] = None, callables: dict = None,
                 graphed: Optional[bool] = None, gated: bool = False,
                 rows: Optional[int] = None):
        self.cfg, self.step, self.masked = cfg, step, masked
        self.interval = interval
        self.callables = callables or {}
        if graphed is None:
            graphed = state.x.device.type == "cuda" and not _EAGER
        self.graphed, self.gated = graphed, gated
        self.block = _block_len(gated, graphed)
        self.meta = _meta(state)
        self.s = state.replace(**{n: getattr(state, n).clone()
                                  for n in _FIELDS if n not in _RING})
        # The iteration caps are device tensors, filled by ``start``, so that
        # a kept runner's graphs serve any cfg.max_iters.
        self.k_max = torch.full_like(state.k, cfg.max_iters)
        self.k_cap = torch.full_like(state.k, cfg.max_iters)
        self.entered = torch.ones_like(state.status, dtype=torch.bool)
        self.flags = torch.zeros(4, dtype=torch.int32, device=state.x.device)
        # The flags come to the host through a pinned buffer and an event,
        # a read that set_sync_debug_mode("error") lets through: it catches
        # any other.
        on_card = state.x.device.type == "cuda"
        self._host_flags = torch.empty(4, dtype=torch.int32,
                                       pin_memory=on_card)
        self._flags_read = torch.cuda.Event() if on_card else None
        self.rows = None
        if rows is not None:
            # One row per iteration after each lane's own axis, as the
            # reference's (vmapped) scan stacks them.
            self.axis = state.x.dim() - 1
            self.step_no = torch.zeros(1, dtype=torch.int64,
                                       device=state.x.device)
            self.rows = {n: torch.empty(
                v.shape[:self.axis] + (rows,) + v.shape[self.axis:],
                dtype=v.dtype, device=v.device)
                for n, v in ((n, getattr(state, n)) for n in _TRACE)}
        self._graphs = {}
        self._pool = None

    def load(self, state: LBFGSState) -> None:
        """Copy ``state`` into the buffers (a field that is already the
        buffer is left as it is)."""
        _copy_into(self.s, state)

    # --- what a graph holds ------------------------------------------------

    def _running(self, s: LBFGSState):
        """``solver._running`` with the cap from ``k_max``."""
        return ((s.status == Status.RUNNING) & (s.g_norm >= self.cfg.tol)
                & (s.k < self.k_max))

    def _go(self, s: LBFGSState):
        return self._running(s) & (s.k < self.k_cap)

    def _block(self, n: int) -> None:
        s = self.s
        for _ in range(n):
            s = self.step(s, lanes=self._go(s) if self.masked else None)
            if self.rows is not None:
                self._emit(s)
        _copy_into(self.s, s)
        if self.masked:
            self._set_flags()

    def _emit(self, s: LBFGSState) -> None:
        """Write this iteration's row of the trace and count the step."""
        for name, buf in self.rows.items():
            buf.index_copy_(self.axis, self.step_no,
                            getattr(s, name).unsqueeze(self.axis))
        self.step_no += 1

    def trace(self) -> Trace:
        """The trace after the loop: the rows past the last step, where the
        state no longer changed, filled with the state's fields on the
        device."""
        rows = next(iter(self.rows.values())).shape[self.axis]
        past = torch.arange(rows, device=self.step_no.device) >= self.step_no
        out = {}
        for name, buf in self.rows.items():
            v = getattr(self.s, name).unsqueeze(self.axis)
            mask = past.reshape((1,) * self.axis + (rows,)
                                + (1,) * (v.dim() - self.axis - 1))
            out[name] = torch.where(mask, v, buf)
        return Trace(**out)

    def _set_flags(self) -> None:
        """[any lane goes on under the cap, any lane runs, the most
        iterations a lane may still take under the cap, the same for the
        next segment], int32 on the device."""
        s, i32 = self.s, torch.int32
        running = self._running(s)
        go = running & (s.k < self.k_cap)
        zero = torch.zeros_like(s.k)
        left = self.k_max - s.k
        if self.interval is not None:
            left = torch.clamp(left, max=self.interval)
        self.flags.copy_(torch.stack([
            go.any().to(i32), running.any().to(i32),
            torch.where(go, self.k_cap - s.k, zero).max(),
            torch.where(running, left, zero).max()]))

    def _refresh(self, keep_entered: bool) -> None:
        out = solver.refresh_products(self.s)
        if keep_entered and self.entered.dim():
            out = solver._keep_lanes(self.entered, out, self.s)
        _copy_into(self.s, out)

    # --- what the host loop calls -------------------------------------------

    def run(self, n: int) -> None:
        """n iterations, one block; no host read."""
        stats["steps"] += n
        self._launch(("iterate", n), lambda: self._block(n))

    def refresh(self, keep_entered: bool) -> None:
        """``refresh_products`` on the buffers; with ``keep_entered``, for
        the lanes that entered the segment only (``start``)."""
        self._launch(("refresh", keep_entered),
                     lambda: self._refresh(keep_entered))

    def start(self, iters: Optional[int]) -> None:
        """A segment of up to ``iters`` more iterations of each lane (None:
        up to ``cfg.max_iters``): its cap, the lanes that enter it, and
        the flags; device work only."""
        s = self.s
        self.k_max.fill_(self.cfg.max_iters)
        self.entered.copy_(self._running(s))
        if iters is None:
            self.k_cap.fill_(self.cfg.max_iters)
        else:
            self.k_cap.copy_(torch.clamp(s.k + iters,
                                         max=self.cfg.max_iters))
        self._set_flags()

    def read(self) -> tuple:
        """One host read of the flags: (go, running, budget, next budget)."""
        stats["host_reads"] += 1
        self._host_flags.copy_(self.flags, non_blocking=True)
        if self._flags_read is not None:
            self._flags_read.record()
            self._flags_read.synchronize()
        go, running, budget, nxt = self._host_flags.tolist()
        return bool(go), bool(running), budget, nxt

    # --- capture and replay -------------------------------------------------

    def _launch(self, key, fn) -> None:
        if not self.graphed:
            fn()
            return
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, fn)
        graph, tally = entry
        graph.replay()
        counts.replay(tally)
        stats["replays"] += 1

    def _warm_up(self, key) -> None:
        """Run what ``key`` captures once on a side stream without changing
        the state: an iteration with every lane masked off (a gated
        runner's searches run one gated turn of each loop), or a refresh
        whose result is dropped.  It builds and loads the kernels, makes the
        libraries' handles and the searches' cached tables, and runs
        autograd once, which a capture cannot.  Its launches count, and
        ``stats["warmup_launches"]`` names them."""
        side = torch.cuda.Stream(device=self.s.x.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), counts.recording() as warm:
            if key[0] == "iterate":
                off = torch.zeros_like(self.s.status, dtype=torch.bool)
                if self.gated:
                    # Each search loop's turn once, no host read.
                    with strategies.gated(graph_if.WarmGate()):
                        self.step(self.s, lanes=off)
                else:
                    self.step(self.s, lanes=off)
                stats["warmups"] += 1
            else:
                solver.refresh_products(self.s)
        counts.ran(warm)
        stats["warmup_launches"].update(warm)
        torch.cuda.current_stream().wait_stream(side)

    def _capture(self, key, fn):
        t0 = time.perf_counter()
        if all(k[0] != key[0] for k in self._graphs):
            self._warm_up(key)
            stats["warmup_s"] += time.perf_counter() - t0
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream()
        gate = None
        if self.gated and key[0] == "iterate":
            # A counter of gated turns for each search loop of the block.
            turns = torch.zeros(4 * key[1] + 4, dtype=torch.int64,
                                device=self.s.x.device)
            gate = graph_if.GraphGate(turns)
        try:
            with counts.recording() as tally, \
                    torch.cuda.graph(graph, pool=self._pool):
                if gate is None:
                    fn()
                else:
                    graph_if.route_to_pool(self.s.x.device.index, self._pool)
                    try:
                        with strategies.gated(gate):
                            fn()
                    except BaseException:
                        gate.abandon()
                        raise
                nodes = graph_if.capture_nodes(torch.cuda.current_stream())
        except RuntimeError as err:
            _end_failed_capture(self._pool, stream)
            names = ", ".join(f"{k}={_name(v)}"
                              for k, v in self.callables.items()
                              if v is not None)
            # Ending a capture that an operation broke fails too: name the
            # operation's error, which the second one hides.
            first = err.__context__ if isinstance(
                err.__context__, RuntimeError) else err
            raise RuntimeError(
                f"capturing a block of the solve ({names}) as a CUDA graph "
                f"failed: {str(first).splitlines()[0]}.  A callable that "
                "reads the host (.item(), bool(), .tolist(), a copy from the "
                "host) cannot be captured; run the solve inside "
                "tpu_lbfgs_torch.eager_loops()") from err
        finally:
            if gate is not None:
                gate.close()
        if gate is not None:
            counts.gated(self, turns, gate.loops, stats)
            stats["while_nodes"] += gate.nodes
            nodes += gate.body_nodes - gate.nodes
        stats["graph_nodes"] += nodes
        stats["captures"] += 1
        stats["capture_s"] += time.perf_counter() - t0
        return graph, tally


def _end_failed_capture(pool, stream) -> None:
    """Undo what ``torch.cuda.graph`` leaves behind when its capture fails
    to end: its stream stays current, and the caching allocator goes on
    routing to the capture's private ``pool``, and while it does it
    returns no memory to the card, not even on running out.  Restore
    ``stream``, end the pool's allocation and release the failed graph's
    hold on the pool."""
    torch.cuda.set_stream(stream)
    dev = torch.cuda.current_device()
    try:
        torch._C._cuda_endAllocateToPool(dev, pool)
    except RuntimeError:
        return                      # the capture ended: the graph owns it
    torch._C._cuda_releasePool(dev, pool)


class Kept:
    """One block runner kept across the solves of one caller, with its
    graphs: a solve of the same kind, configuration (``max_iters`` aside),
    callables, shapes and route as the last one replays what that one
    captured, its state copied into the kept buffers (module docstring)."""

    def __init__(self):
        self.key, self.runner = None, None


def _block_len(gated: bool, graphed: bool) -> int:
    return GATED_BLOCK_ITERS if gated and graphed else BLOCK_ITERS


def captures(device: torch.device, budget: int, gated: bool = False) -> bool:
    """Whether a solve of at most ``budget`` iterations on ``device``
    captures its blocks: on a CUDA device outside ``eager_loops()``, from
    a budget of ``CAPTURE_MIN_ITERS``, or ``GATED_CAPTURE_MIN_ITERS``
    where its line search loops (``gated``)."""
    least = GATED_CAPTURE_MIN_ITERS if gated else CAPTURE_MIN_ITERS
    return device.type == "cuda" and not _EAGER and budget >= least


def runner(kind: str, cfg, step: Callable, state: LBFGSState,
           interval: Optional[int], callables: dict, budget: int,
           kept: Optional[Kept] = None) -> BlockRunner:
    """The runner of one solve of at most ``budget`` iterations: its blocks
    captured where ``captures`` says so.  ``kind``: "while", "segment",
    "traced" (the while forms) or "bounded".  With ``kept``, the runner it
    holds when it matches, ``state`` copied in, else a new one that it
    holds."""
    masked = kind != "bounded"
    gated = strategies.reads_on_host(cfg, state.x.dim() == 2)
    graphed = captures(state.x.device, budget, gated)
    rows = cfg.max_iters if kind == "traced" else None
    args = (cfg, step, state, masked, interval, callables, graphed, gated,
            rows)
    if kept is None:
        return BlockRunner(*args)
    # The graphs read the iteration caps from the device: one runner serves
    # every max_iters (a harness's short warm-up and its long solve).
    key = (kind, cfg.replace(max_iters=0), interval,
           _block_len(gated, graphed), graphed,
           chain._whole_batch, tuple(callables.items()), _meta(state))
    if kept.key != key:
        kept.key, kept.runner = key, BlockRunner(*args)
    else:
        kept.runner.cfg = cfg
        kept.runner.load(state)
    return kept.runner


def _steps(drv: BlockRunner, n: int) -> None:
    """n iterations as full blocks and single iterations, no read."""
    full, rest = divmod(n, drv.block)
    for _ in range(full):
        drv.run(drv.block)
    for _ in range(rest):
        drv.run(1)


def _drain(drv: BlockRunner, budget: int) -> tuple:
    """Blocks while a lane goes on under the segment's cap, ``budget`` the
    most iterations a lane may still take; one read after each block.
    Returns the last flags read."""
    while True:
        _steps(drv, min(budget, BLOCK_ITERS))
        flags = drv.read()
        go, _, budget, _ = flags
        if not go:
            return flags


def solve_while(drv: BlockRunner, interval: Optional[int]) -> LBFGSState:
    """``solve_from_state``'s loop: while any lane runs; with ``interval``
    in segments of up to that many iterations, each followed by a refresh
    of the lanes that entered it (the reference's nested ``while_loop``).
    Reads 1 + one per block."""
    drv.start(interval)
    go, running, budget, _ = drv.read()
    if interval is None:
        if go:
            _drain(drv, budget)
        return drv.s
    while running:
        _, running, _, budget = _drain(drv, budget)
        drv.refresh(keep_entered=True)
        if running:
            drv.start(interval)
    return drv.s


def solve_traced(drv: BlockRunner, interval: Optional[int]) -> LBFGSState:
    """``_solve_traced``'s loop: ``solve_while``'s, each iteration writing
    its row of the trace (``BlockRunner.trace``); with ``interval`` a
    refresh of every lane after each segment, and after the first one
    whatever ran, as the per-iteration trace refreshes.  Reads 1 + one
    per block."""
    drv.start(interval)
    go, running, budget, _ = drv.read()
    if interval is None:
        if go:
            _drain(drv, budget)
        return drv.s
    while True:
        if running:
            _, running, _, budget = _drain(drv, budget)
        drv.refresh(keep_entered=False)
        if not running:
            return drv.s
        drv.start(interval)


def solve_segment(drv: BlockRunner, iters: int,
                  refresh: bool) -> LBFGSState:
    """``make_solve_segment``'s segment: up to ``iters`` more iterations of
    each lane while it runs, then the refresh when asked for."""
    drv.start(iters)
    go, _, budget, _ = drv.read()
    if go:
        _drain(drv, budget)
    if refresh:
        drv.refresh(keep_entered=False)
    return drv.s


def solve_fixed(drv: BlockRunner, iters: int,
                interval: Optional[int]) -> LBFGSState:
    """``solve_bounded``'s loop: exactly ``iters`` iterations, a refresh
    after every full ``interval`` of them; no host read."""
    if interval is None:
        _steps(drv, iters)
        return drv.s
    segments, rest = divmod(iters, interval)
    for _ in range(segments):
        _steps(drv, interval)
        drv.refresh(keep_entered=False)
    _steps(drv, rest)
    return drv.s
