"""Carry solver state between ``tpu_lbfgs`` and ``tpu_lbfgs_torch``.

A state crosses as a dict ``{field: numpy array}`` of the reference's
``LBFGSState`` fields (``{k: np.asarray(v) for k, v in s._asdict().items()}``
on the JAX side), with the history ring in the reference's ``(m, R, L)``
layout.  A batched state (``jax.vmap(init_state)`` on the JAX side) has a
leading lane axis on every field, and its ring is ``(B, m, R, L)``.  Both
directions copy, so the two solvers never share a buffer.  A ``Trace``
crosses the same way, field by field.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import LBFGSState, Trace

_LANES = 128


def hist_block(d: int) -> tuple[int, int]:
    """(R, L) with R * L = d: the reference's per-pair ring row layout
    (``tpu_lbfgs.types.hist_block``)."""
    if d % _LANES == 0 and d >= _LANES:
        return d // _LANES, _LANES
    return 1, d


def state_from_numpy(arrays: dict, device="cpu") -> LBFGSState:
    """The port's state on ``device`` from a reference state's arrays; the
    (..., m, R, L) ring becomes a flat (..., m, d) ring."""
    fields = {}
    for f in dataclasses.fields(LBFGSState):
        t = torch.from_numpy(np.array(arrays[f.name], copy=True)).to(device)
        if f.name in ("s_hist", "y_hist"):
            t = t.flatten(-2)
        fields[f.name] = t
    return LBFGSState(**fields)


def state_to_numpy(state: LBFGSState) -> dict:
    """A reference state's arrays from the port's state (ring as
    (..., m, R, L))."""
    out = {}
    for f in dataclasses.fields(LBFGSState):
        a = getattr(state, f.name).detach().cpu().numpy().copy()
        if f.name in ("s_hist", "y_hist"):
            a = a.reshape(a.shape[:-1] + hist_block(a.shape[-1]))
        out[f.name] = a
    return out


def trace_from_numpy(arrays: dict, device="cpu") -> Trace:
    """The port's Trace on ``device`` from a reference trace's arrays
    (``trace._asdict()`` on the JAX side)."""
    return Trace(**{name: torch.from_numpy(
        np.array(arrays[name], copy=True)).to(device)
        for name in Trace._fields})


def trace_to_numpy(trace: Trace) -> dict:
    """A reference trace's arrays from the port's Trace."""
    return {name: getattr(trace, name).detach().cpu().numpy().copy()
            for name in Trace._fields}
