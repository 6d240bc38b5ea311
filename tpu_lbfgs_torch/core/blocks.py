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
(``solver._run_segment``) where a block cannot be captured: a sharded
solve (``comm``; gloo's collectives go through the host), under
``set_debug_nans(True)`` (it reads by design), a traced solve, and a line
search that reads its loop condition on the host (``strategies.
reads_on_host``; under ``solve_bounded`` every search runs its fixed
trip and reads nothing).

Buffers.  A graph reads and writes fixed addresses, so a runner owns the
state it iterates: a copy of every field of the state handed in but the
ring, whose rows ``iterate`` writes in place as it always did (the state
handed in gives its ring to the solve).  So a solve holds no second ring,
at d = 1e8 and m = 10 8 GB.  The warm-up before the first capture
iterates with every lane masked off, which runs every kernel and leaves
the state as it was.  Each runner's graphs share one private memory pool,
which holds a block's temporaries for as long as the runner lives.

A solve captures only when its budget, the most iterations its arguments
let it run, is at least ``CAPTURE_MIN_ITERS``: below that, a capture
costs more than the eager blocks it would replace, and the blocks run
eagerly on the card too, as do ``solve_bounded``'s blocks of a batch
under a search that loops, whose fixed trip makes graphs too large to pay
(``solver._captured``).  A solve makes its runner and drops it at its
end, so each call captures anew, as a solve that is not kept would
compile anew.  A caller that runs many solves of one configuration keeps
one runner in a ``Kept`` and hands it to each (``make_solve_segment``'s
segment function and the harnesses do): a kept runner copies each new
state into its buffers and returns them, so the state it returned before
is overwritten, as the reference's donated buffers are (a segment
function under ``donate=False`` returns a copy).
"""
from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Callable, Optional

import torch

from ..kernels import chain, counts
from ..types import LBFGSState, Status
from . import solver

#: Iterations per captured block.  A solve that ends inside a block
#: replays up to BLOCK_ITERS - 1 frozen iterations.
BLOCK_ITERS = 20
#: The least budget of a solve that captures its blocks (module docstring).
CAPTURE_MIN_ITERS = 2 * BLOCK_ITERS

#: Blocks since the last ``reset_stats()``: graphs captured and the host
#: seconds they took (warm-up included), warm-up iterations, replays,
#: iterations stepped on the device (frozen ones included, eager or
#: replayed), and host reads of the loop's flags.
stats = {"captures": 0, "capture_s": 0.0, "warmups": 0, "replays": 0,
         "steps": 0, "host_reads": 0}

_EAGER = False

_RING = ("s_hist", "y_hist")
_FIELDS = tuple(f.name for f in dataclasses.fields(LBFGSState))


def reset_stats() -> None:
    for name in stats:
        stats[name] = type(stats[name])()


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
    ``eager_loops()``."""

    def __init__(self, cfg, step: Callable, state: LBFGSState, masked: bool,
                 interval: Optional[int] = None, callables: dict = None,
                 graphed: Optional[bool] = None):
        self.cfg, self.step, self.masked = cfg, step, masked
        self.interval = interval
        self.callables = callables or {}
        if graphed is None:
            graphed = state.x.device.type == "cuda" and not _EAGER
        self.graphed = graphed
        self.meta = _meta(state)
        self.s = state.replace(**{n: getattr(state, n).clone()
                                  for n in _FIELDS if n not in _RING})
        # The iteration caps are device tensors, filled by ``start``, so that
        # a kept runner's graphs serve any cfg.max_iters.
        self.k_max = torch.full_like(state.k, cfg.max_iters)
        self.k_cap = torch.full_like(state.k, cfg.max_iters)
        self.entered = torch.ones_like(state.status, dtype=torch.bool)
        self.flags = torch.zeros(4, dtype=torch.int32, device=state.x.device)
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
        _copy_into(self.s, s)
        if self.masked:
            self._set_flags()

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
        go, running, budget, nxt = self.flags.tolist()
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
        the state: an iteration with every lane masked off, or a refresh
        whose result is dropped.  It builds and loads the kernels, makes the
        libraries' handles and the searches' cached tables, and runs
        autograd once, which a capture cannot."""
        side = torch.cuda.Stream(device=self.s.x.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            if key[0] == "iterate":
                off = torch.zeros_like(self.s.status, dtype=torch.bool)
                self.step(self.s, lanes=off)
                stats["warmups"] += 1
            else:
                solver.refresh_products(self.s)
        torch.cuda.current_stream().wait_stream(side)

    def _capture(self, key, fn):
        t0 = time.perf_counter()
        if all(k[0] != key[0] for k in self._graphs):
            self._warm_up(key)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.current_stream()
        try:
            with counts.recording() as tally, \
                    torch.cuda.graph(graph, pool=self._pool):
                fn()
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


def runner(kind: str, cfg, step: Callable, state: LBFGSState,
           interval: Optional[int], callables: dict, budget: int,
           capture: bool = True, kept: Optional[Kept] = None) -> BlockRunner:
    """The runner of one solve of at most ``budget`` iterations: its blocks
    captured on a CUDA device outside ``eager_loops()`` when ``capture``
    holds and ``budget`` is at least ``CAPTURE_MIN_ITERS``.  With ``kept``,
    the runner it holds when it matches, ``state`` copied in, else a new
    one that it holds."""
    masked = kind != "bounded"
    graphed = (capture and state.x.device.type == "cuda" and not _EAGER
               and budget >= CAPTURE_MIN_ITERS)
    if kept is None:
        return BlockRunner(cfg, step, state, masked, interval, callables,
                           graphed)
    # The graphs read the iteration caps from the device: one runner serves
    # every max_iters (a harness's short warm-up and its long solve).
    key = (kind, cfg.replace(max_iters=0), interval, BLOCK_ITERS, graphed,
           chain._whole_batch, tuple(callables.items()), _meta(state))
    if kept.key != key:
        kept.key, kept.runner = key, BlockRunner(
            cfg, step, state, masked, interval, callables, graphed)
    else:
        kept.runner.cfg = cfg
        kept.runner.load(state)
    return kept.runner


def _steps(drv: BlockRunner, n: int) -> None:
    """n iterations as full blocks and single iterations, no read."""
    full, rest = divmod(n, BLOCK_ITERS)
    for _ in range(full):
        drv.run(BLOCK_ITERS)
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
