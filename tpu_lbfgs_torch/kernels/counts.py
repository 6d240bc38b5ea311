"""Kernel launch counts that see through CUDA graphs.

A wrapper calls ``count(launches, name)`` where it launches its kernel.
Outside a graph capture that is one kernel run on the device, and it adds
one to its module's ``launches``.  Inside a capture (``core.blocks``) the
kernel is only recorded into the graph: the call adds one to the capture's
own tally (``recording``), and every replay of that graph adds the tally to
``launches`` and to ``replayed`` (``replay``).

So ``launches`` counts the kernels the device ran, eager or replayed, and
``replayed`` the part of ``launches`` that graphs ran: a check says which
one it means.

A launch inside the body of a graph's WHILE node (the gated line-search
loops, ``kernels.graph_if``) runs as many times as the replays run its
turn, so it is kept out of the graph's tally: each gated loop records its
turn's launches in a tally of its own, and a counter on the device counts
the turns the replays ran.  ``fold()`` adds tally x turns into the counts,
one host read per live capture (the captures of runners that are gone are
merged on the device as new ones come, ``_retire``);
``kernels.launch_counts()`` folds before it reads, so nothing is read on
the host inside a solve.
"""
from __future__ import annotations

import weakref
from collections import Counter
from contextlib import contextmanager

import torch

#: Kernel runs by graph replays, by wrapper name (included in ``launches``).
replayed: Counter = Counter()

_recording: list = []
_owner: dict = {}


def count(launches: dict, name: str) -> None:
    """One launch of ``name``'s kernel, whose module counts in
    ``launches``."""
    _owner[name] = launches
    if _recording:
        _recording[-1][name] += 1
    else:
        launches[name] += 1


def push(tally: Counter) -> None:
    """Record the launches made from now on into ``tally`` (``pop``)."""
    _recording.append(tally)


def pop() -> Counter:
    """Stop recording into the tally of the last ``push``; returns it."""
    return _recording.pop()


@contextmanager
def recording():
    """The tally of the launches made while a graph is captured."""
    tally = Counter()
    push(tally)
    try:
        yield tally
    finally:
        pop()


def _add(tally: Counter, times: int) -> None:
    for name, n in tally.items():
        _owner[name][name] += n * times
        replayed[name] += n * times


def replay(tally: Counter) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    _add(tally, 1)


def ran(tally: Counter) -> None:
    """Count the eager launches recorded in ``tally`` (not replays)."""
    for name, n in tally.items():
        _owner[name][name] += n


#: The gated loops of the captures whose turns are not all folded yet:
#: [the graphs' owner (weak; None for the loops of captures retired by
#: ``_retire``), the turn counters, [(slot, tally)], turns folded per
#: loop, the stats dict that counts "gated_turns"].
_gated: list = []


def gated(owner, turns, loops: list, sink: dict) -> None:
    """Register the gated loops of one capture: loop i's captured turn
    recorded ``loops[i] = (slot, tally)``, and ``turns[slot]`` (an int64
    tensor on the device) counts the turns of it that the replays of
    ``owner``'s graphs ran.  Outside a capture."""
    _retire()
    _gated.append([weakref.ref(owner), turns, loops, [0] * len(loops), sink])


def _retire() -> None:
    """Merge the loops of every capture whose owner is gone, whose counters
    no replay moves any more, into one entry per device and sink: a
    counter per distinct tally, summed on the device with no host read.
    So a program that solves in a loop, capturing anew each time, keeps
    one entry per live runner and one per device and sink."""
    merged = {(e[1].device, id(e[4])): e for e in _gated if e[0] is None}
    keep = []
    for entry in _gated:
        owner, turns, loops, folded, sink = entry
        if owner is None or owner() is not None:
            keep.append(entry)
            continue
        into = merged.get((turns.device, id(sink)))
        if into is None:
            into = merged[(turns.device, id(sink))] = \
                [None, turns.new_zeros(0), [], [], sink]
            keep.append(into)
        for (slot, tally), done in zip(loops, folded):
            k = next((k for k, t in into[2] if t == tally), None)
            if k is None:
                k = len(into[2])
                into[1] = torch.cat([into[1], turns.new_zeros(1)])
                into[2].append((k, tally))
                into[3].append(0)
            into[1][k] += turns[slot] - done
    _gated[:] = keep


def fold() -> None:
    """Add each gated loop's tally times the turns it ran since the last
    fold to the counts (and those turns to its sink's "gated_turns"); a
    capture whose owner is gone is dropped once folded.  One host read per
    entry registered."""
    keep = []
    for entry in _gated:
        owner, turns, loops, folded, sink = entry
        now = turns.tolist()
        for i, (slot, tally) in enumerate(loops):
            _add(tally, now[slot] - folded[i])
            sink["gated_turns"] += now[slot] - folded[i]
            folded[i] = now[slot]
        if owner is None or owner() is not None:
            keep.append(entry)
    _gated[:] = keep


def reset() -> None:
    replayed.clear()
