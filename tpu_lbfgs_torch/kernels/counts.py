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
"""
from __future__ import annotations

from collections import Counter
from contextlib import contextmanager

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


@contextmanager
def recording():
    """The tally of the launches made while a graph is captured."""
    tally = Counter()
    _recording.append(tally)
    try:
        yield tally
    finally:
        _recording.pop()


def replay(tally: Counter) -> None:
    """Count one replay of a graph whose capture recorded ``tally``."""
    for name, n in tally.items():
        _owner[name][name] += n
        replayed[name] += n


def reset() -> None:
    replayed.clear()
