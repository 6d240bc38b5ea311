"""Checkpoint and resume of a single-instance or batched solver state
(``tpu_lbfgs.io.checkpoint.save_state`` / ``load_state``).

A checkpoint is the reference's ``.npz`` file, readable and writable by
both packages: a schema key, ``tpu-lbfgs-state-v1``, and one array per
field of the reference's ``LBFGSState``, the history ring in its
``(m, R, L)`` layout (``interop.state_to_numpy``).  numpy has no bfloat16,
so a bfloat16 ring is stored as its float32 values, exactly, and
``__casts__`` (a JSON string, ``{"s_hist": "bfloat16", ...}``) records the
dtype that ``load_state`` narrows it back to, bit for bit.

``save_state`` copies the state to the host before it returns, so the
solver may go on with the same state: ``iterate`` writes the ring in place
(``core.solver``), which makes the state handed to a segment invalid once
that segment has run, never the file.  Resuming a ``make_solve_segment``
loop from a file gives the uncut solve bit for bit when the segments have
the same lengths: with ``cfg.refresh_interval`` set, the history products
are refreshed at every segment's end, so a cut is a refresh point.

The per-shard layout (``save_state_sharded`` / ``load_state_sharded``)
waits for a state-in entry of the sharded solve (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..interop import state_from_numpy, state_to_numpy
from ..types import Guard, LBFGSState

_SCHEMA = "tpu-lbfgs-state-v1"
_FIELDS = tuple(f.name for f in dataclasses.fields(LBFGSState))


def save_state(path, state: LBFGSState) -> None:
    """Write ``state`` to ``path`` as the reference's ``.npz``.  The file
    is written next to ``path`` and moved over it in one step, so a crash
    leaves the old checkpoint or the new one, never a torn file."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    casts = {name: "bfloat16" for name in _FIELDS
             if getattr(state, name).dtype == torch.bfloat16}
    arrays = state_to_numpy(state)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, __schema__=np.asarray(_SCHEMA),
                 __casts__=np.asarray(json.dumps(casts)), **arrays)
    os.replace(tmp, path)


def load_state(path, dtype=None, device=None) -> LBFGSState:
    """The state saved at ``path``, on ``device`` (``types.resolve_device``:
    the current CUDA device unless "cpu" is asked for).  ``dtype`` (a
    torch dtype or its name) casts every floating field to it (a bfloat16
    ring's carrier included); without it each field keeps its saved
    dtype.  A ``guards`` field that
    is absent or shorter than ``Guard.N`` (a file from before a counter
    was added) is zero-extended."""
    with np.load(Path(path), allow_pickle=False) as z:
        schema = str(z["__schema__"])
        if schema != _SCHEMA:
            raise ValueError(f"unknown checkpoint schema {schema!r}")
        casts = json.loads(str(z["__casts__"])) if "__casts__" in z else {}
        arrays = {name: z[name] for name in _FIELDS if name in z}
    lead = arrays["x"].shape[:-1]
    guards = arrays.get("guards", np.zeros(lead + (Guard.N,), np.int32))
    if guards.shape[-1] < Guard.N:
        pad = [(0, 0)] * (guards.ndim - 1) + [(0, Guard.N - guards.shape[-1])]
        guards = np.pad(guards, pad)
    arrays["guards"] = guards
    state = state_from_numpy(arrays, device)
    if dtype is not None:
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return state.replace(**{
            name: t.to(dtype) for name in _FIELDS
            if (t := getattr(state, name)).is_floating_point()})
    return state.replace(**{name: getattr(state, name).to(getattr(torch, c))
                            for name, c in casts.items()})
