"""CUDA graph WHILE nodes: the gate under which the gated line-search
driver (``linesearch.strategies._gated``) captures each search loop inside
a block's CUDA graph (``core.blocks``), so that a replay runs the loop's
turn while the search runs, as the reference's ``lax.while_loop`` does,
with no host read.

The node comes from ``csrc/graph_if.cu`` (``tl_graph_while_begin`` /
``tl_graph_while_end``) through the runtime API: some torch releases have
no capture methods for conditional nodes, the one on the card among them.
A loop's one turn is captured on a stream of the gate's own, which the gate
makes torch's current stream while the turn is captured, into a graph of
its own that goes into the node's body once its capture has ended, so that
a turn whose capture breaks leaves the block's graph whole and the
capture's error is raised; its allocations go to the block's private
memory pool (``route_to_pool``), as the rest of the block's do.  The body
ends with a condition kernel, a node of the body graph's own, that reads
the predicate the turn rewrote, so a search costs one captured turn
whatever its trip bound.  A lane that has ended keeps its carry, so the
gated driver equals the read-driven and fixed-trip drivers bit for bit.

Launch counts: each gated loop records its turn's launches apart from the
block's tally, and the condition kernels count on the device the turns
that run (``counts.gated``, ``counts.fold``).
"""
from __future__ import annotations

import ctypes
from typing import Callable

import torch
from torch import Tensor

from . import _build, counts


def capture_nodes(stream) -> int:
    """The nodes of the graph that ``stream`` is capturing so far."""
    lib, nodes = _build.load(), ctypes.c_longlong(0)
    _build.check(lib, lib.tl_capture_nodes(stream.cuda_stream,
                                           ctypes.byref(nodes)),
                 "counting a capture's nodes")
    return nodes.value


def route_to_pool(device: int, pool) -> None:
    """Route every allocation on ``device`` to the capture's private
    ``pool`` for the rest of the capture, whatever its stream: the capture
    routes only its own stream's, and a WHILE body is captured on another.
    The capture's end stops it.  The pool's use count is left as it was."""
    torch._C._cuda_endAllocateToPool(device, pool)
    torch._C._cuda_beginAllocateToPool(device, pool)
    torch._C._cuda_releasePool(device, pool)


class GraphGate:
    """The gated driver's gate while a block's graph is captured: each
    search loop one WHILE node on ``pred``, its one turn captured on the
    gate's own stream.  ``turns``: an int64 tensor on the device, one slot
    per gated loop of the capture, in which the condition kernels count
    the turns run.

    ``nodes``: the WHILE nodes captured (one per loop), ``body_nodes`` the
    nodes of every body (its turn's and its condition kernel); ``loops``:
    (slot, the turn's launches) of each gated loop, for ``counts.gated``."""

    def __init__(self, turns: Tensor):
        self.lib = _build.load()
        self.turns = turns
        ptr = ctypes.c_void_p()
        _build.check(self.lib, self.lib.tl_stream_create(ctypes.byref(ptr)),
                     "creating the WHILE bodies' stream")
        self.body = torch.cuda.ExternalStream(ptr.value, device=turns.device)
        self.outer = None
        self.loops, self.nodes = [], 0
        self._body_nodes = ctypes.c_longlong(0)
        self._open, self._abandoned = False, False

    def loop(self, pred: Tensor, turn: Callable[[], None]) -> None:
        """A WHILE node on ``pred`` (a bool on the device) after what has
        been captured, its body ``turn()``, which rewrites ``pred``."""
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise ValueError("a loop's predicate is one bool")
        slot = len(self.loops)
        if slot >= self.turns.numel():
            raise RuntimeError(f"a block holds more than {slot} gated "
                               "line-search loops")
        counter = self.turns[slot].data_ptr()
        self.outer = torch.cuda.current_stream()
        graph, handle = ctypes.c_void_p(), ctypes.c_ulonglong()
        _build.check(self.lib, self.lib.tl_graph_while_begin(
            self.outer.cuda_stream, pred.data_ptr(), counter,
            self.body.cuda_stream, ctypes.byref(graph), ctypes.byref(handle)),
            "adding a WHILE node to the graph")
        torch.cuda.set_stream(self.body)
        self._open = True
        with counts.recording() as tally:
            turn()
        self._open = False
        _build.check(self.lib, self.lib.tl_graph_while_end(
            self.body.cuda_stream, graph, handle, pred.data_ptr(), counter,
            ctypes.byref(self._body_nodes)), "ending a WHILE node's body")
        torch.cuda.set_stream(self.outer)
        self.loops.append((slot, tally))
        self.nodes += 1

    @property
    def body_nodes(self) -> int:
        return self._body_nodes.value

    def abandon(self) -> None:
        """After an error during the capture: end the capture of a body
        still open and drop what it captured, then end and drop the
        block's own capture, so that the block's capture fails to end as
        one that broke outside any body does; leave torch's stream as it
        was before."""
        self._abandoned = True
        if self._open:
            self.lib.tl_capture_abort(self.body.cuda_stream)
            self.lib.tl_capture_abort(self.outer.cuda_stream)
            self._open = False
            torch.cuda.set_stream(self.outer)

    def close(self) -> None:
        """Destroy the gate's stream once the capture has ended (after a
        failed one, whatever its state: the capture's own error is the one
        raised)."""
        err = self.lib.tl_stream_destroy(self.body.cuda_stream)
        if not self._abandoned:
            _build.check(self.lib, err, "destroying the WHILE bodies' stream")


class WarmGate:
    """The gate of a block's warm-up before its capture (``core.blocks``):
    each loop's turn runs once, eagerly, with no host read, so that every
    search body makes its tables, handles and libraries before the
    capture."""

    def loop(self, pred: Tensor, turn: Callable[[], None]) -> None:
        turn()
