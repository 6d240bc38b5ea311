"""CUDA graph IF nodes: the gate under which the gated line-search driver
(``linesearch.strategies._gated``) captures each turn of a search inside a
block's CUDA graph (``core.blocks``), so that a replay runs a turn only
while the search runs, as the reference's ``lax.while_loop`` does, with no
host read.

The node comes from ``csrc/graph_if.cu`` (``tl_graph_if_begin`` /
``tl_graph_if_end``) through the runtime API: some torch releases have no
capture methods for IF nodes (``CUDAGraph.begin_capture_to_if_node``), the
one on the card among them.  A turn's body is captured on a stream of the
gate's own, which the gate makes torch's current stream while a body is
open, into a graph of its own that goes into the node once its capture
has ended, so that a body whose capture breaks leaves the block's graph
whole and the capture's error is raised; its allocations go to the
block's private memory pool (``route_to_pool``), as the rest of the
block's do.

Turn t + 1's predicate and IF node sit inside turn t's body, so a search
that has ended costs one check and not one per turn left (on the card a
form with every turn's node in the block's graph cost up to 4.5x as much a
replay, PERF.md).  A lane that has ended keeps its carry, so the gated
driver equals the read-driven and fixed-trip drivers bit for bit.

Launch counts: each gated loop records its first turn's launches apart
from the block's tally, and the condition kernel counts on the device the
turns that run (``counts.gated``, ``counts.fold``).
"""
from __future__ import annotations

import ctypes
from collections import Counter

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
    routes only its own stream's, and an IF body is captured on another.
    The capture's end stops it.  The pool's use count is left as it was."""
    torch._C._cuda_endAllocateToPool(device, pool)
    torch._C._cuda_beginAllocateToPool(device, pool)
    torch._C._cuda_releasePool(device, pool)


class GraphGate:
    """The gated driver's gate while a block's graph is captured: each turn
    an IF node on ``pred``, its body captured on the gate's own stream.
    ``turns``: an int64 tensor on the device, one slot per gated loop of
    the capture, in which the condition kernel counts the turns run.

    ``nodes``: the IF nodes captured, ``top_nodes`` those in the block's
    graph itself (each loop's first: the rest nest in the bodies),
    ``body_nodes`` the nodes of every body (a nested node aside);
    ``loops``: (slot, the first gated turn's launches) of each
    gated loop, for ``counts.gated``."""

    def __init__(self, turns: Tensor):
        self.lib = _build.load()
        self.turns = turns
        ptr = ctypes.c_void_p()
        _build.check(self.lib, self.lib.tl_stream_create(ctypes.byref(ptr)),
                     "creating the IF bodies' stream")
        self.body = torch.cuda.ExternalStream(ptr.value, device=turns.device)
        self.outer = None
        self.loops, self.nodes, self.top_nodes = [], 0, 0
        self._body_nodes = ctypes.c_longlong(0)
        self._open = []         # the tally of each body open now
        self._bodies = []       # the body graph of each node open now
        self._loop, self._abandoned = None, False

    def start(self) -> None:
        """A new gated loop."""
        slot = len(self.loops)
        if slot >= self.turns.numel():
            raise RuntimeError(f"a block holds more than {slot} gated "
                               "line-search loops")
        self._loop = [slot, Counter(), True]
        self.loops.append(tuple(self._loop[:2]))

    def open(self, pred: Tensor) -> bool:
        """An IF node on ``pred`` (a bool on the device) after what has been
        captured, inside the body of the loop's last node if one is open;
        the turn's body is captured from here."""
        if pred.dtype != torch.bool or pred.numel() != 1:
            raise ValueError("an IF node's predicate is one bool")
        slot, tally, first = self._loop
        inside = bool(self._open)
        if not inside:
            self.outer = torch.cuda.current_stream()
        parent = self.body if inside else self.outer
        graph = ctypes.c_void_p()
        _build.check(self.lib, self.lib.tl_graph_if_begin(
            parent.cuda_stream, self._bodies[-1] if inside else None,
            pred.data_ptr(), self.turns[slot].data_ptr(),
            self.body.cuda_stream, ctypes.byref(graph),
            ctypes.byref(self._body_nodes)),
            "adding an IF node to the graph")
        if not inside:
            torch.cuda.set_stream(self.body)
            self.top_nodes += 1
        self._bodies.append(graph.value)
        self._loop[2] = False
        self._open.append(tally if first else Counter())
        counts.push(self._open[-1])
        self.nodes += 1
        return True

    def end(self) -> None:
        """The loop's turns are captured: end the bodies open."""
        if not self._open:
            return
        tally = self.loops[self._loop[0]][1]
        innermost = self._bodies[-1]
        while self._open:
            self._open.pop()
            self._bodies.pop()
            got = counts.pop()
            if got != tally:
                raise RuntimeError(
                    f"a gated turn launched {dict(got)}, its first turn "
                    f"{dict(tally)}")
        # The enclosing bodies went into their nodes as each nested node
        # began: the innermost body is the one still captured.
        _build.check(self.lib, self.lib.tl_graph_if_end(
            self.body.cuda_stream, innermost,
            ctypes.byref(self._body_nodes)), "ending an IF node's body")
        torch.cuda.set_stream(self.outer)

    @property
    def body_nodes(self) -> int:
        return self._body_nodes.value

    def abandon(self) -> None:
        """After an error during the capture: end the capture of a body
        still open and drop what it captured, then end and drop the
        block's own capture, so that the block's capture fails to end as
        one that broke outside any body does; leave the launch counts'
        stack and torch's stream as they were before."""
        self._abandoned = True
        if self._open:
            self.lib.tl_capture_abort(self.body.cuda_stream)
            self.lib.tl_capture_abort(self.outer.cuda_stream)
            for _ in self._open:
                counts.pop()
            self._open.clear()
            self._bodies.clear()
            torch.cuda.set_stream(self.outer)

    def close(self) -> None:
        """Destroy the gate's stream once the capture has ended (after a
        failed one, whatever its state: the capture's own error is the one
        raised)."""
        err = self.lib.tl_stream_destroy(self.body.cuda_stream)
        if not self._abandoned:
            _build.check(self.lib, err, "destroying the IF bodies' stream")


class WarmGate:
    """The gate of a block's warm-up before its capture (``core.blocks``):
    one gated turn of each loop runs, eagerly, with no host read, so that
    every search body makes its tables, handles and libraries before the
    capture."""

    def start(self) -> None:
        self._first = True

    def open(self, pred: Tensor) -> bool:
        first, self._first = self._first, False
        return first

    def end(self) -> None:
        pass
