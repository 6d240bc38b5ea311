"""Carry solver state between ``tpu_lbfgs`` and ``tpu_lbfgs_torch``.

A state crosses as a dict ``{field: numpy array}`` of the reference's
``LBFGSState`` fields (``{k: np.asarray(v) for k, v in s._asdict().items()}``
on the JAX side), with the history ring in the reference's ``(m, R, L)``
layout.  A batched state (``jax.vmap(init_state)`` on the JAX side) has a
leading lane axis on every field, and its ring is ``(B, m, R, L)``.  Both
directions copy, so the two solvers never share a buffer.  A ``Trace``
crosses the same way, field by field.

numpy has no bfloat16, so a bfloat16 ring crosses as float32 values, each
exactly representable in bfloat16: ``state_to_numpy`` widens it (on the JAX
side ``jnp.asarray(a).astype(jnp.bfloat16)`` restores it exactly), and
``state_from_numpy`` takes ``history_dtype="bfloat16"`` to narrow such a
carrier again (it also takes the JAX side's ``ml_dtypes`` bfloat16 arrays
as they are).

A sharded state (``dist``) crosses through ``gather_state`` /
``shard_state``: gathered, it has the reference's whole-vector fields.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import LBFGSState, Trace, resolve_device

_LANES = 128


def hist_block(d: int) -> tuple[int, int]:
    """(R, L) with R * L = d: the reference's per-pair ring row layout
    (``tpu_lbfgs.types.hist_block``)."""
    if d % _LANES == 0 and d >= _LANES:
        return d // _LANES, _LANES
    return 1, d


def state_from_numpy(arrays: dict, device=None,
                     history_dtype=None) -> LBFGSState:
    """The port's state on ``device`` (``types.resolve_device``: the current
    CUDA device unless "cpu" is asked for) from a reference state's arrays;
    the (..., m, R, L) ring becomes a flat (..., m, d) ring, in
    ``history_dtype`` when given ("bfloat16": the carrier's float32 values
    must be representable, which the cast then keeps exactly)."""
    device = resolve_device(device)
    fields = {}
    for f in dataclasses.fields(LBFGSState):
        a = np.asarray(arrays[f.name])
        ring = f.name in ("s_hist", "y_hist")
        narrow = ring and a.dtype.name == "bfloat16"
        if narrow:
            a = a.astype(np.float32)     # exact; torch reads no ml_dtypes
        t = torch.from_numpy(np.array(a, copy=True)).to(device)
        if ring:
            t = t.flatten(-2)
            if narrow:
                t = t.to(torch.bfloat16)
            elif history_dtype is not None:
                t = t.to(getattr(torch, history_dtype))
        fields[f.name] = t
    return LBFGSState(**fields)


def state_to_numpy(state: LBFGSState) -> dict:
    """A reference state's arrays from the port's state (ring as
    (..., m, R, L); a bfloat16 ring as the same values in float32)."""
    out = {}
    for f in dataclasses.fields(LBFGSState):
        t = getattr(state, f.name).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        a = t.numpy().copy()
        if f.name in ("s_hist", "y_hist"):
            a = a.reshape(a.shape[:-1] + hist_block(a.shape[-1]))
        out[f.name] = a
    return out


def trace_from_numpy(arrays: dict, device=None) -> Trace:
    """The port's Trace on ``device`` (``types.resolve_device``) from a
    reference trace's arrays (``trace._asdict()`` on the JAX side)."""
    device = resolve_device(device)
    return Trace(**{name: torch.from_numpy(
        np.array(arrays[name], copy=True)).to(device)
        for name in Trace._fields})


def trace_to_numpy(trace: Trace) -> dict:
    """A reference trace's arrays from the port's Trace."""
    return {name: getattr(trace, name).detach().cpu().numpy().copy()
            for name in Trace._fields}


_SHARDED_FIELDS = ("x", "g", "s_hist", "y_hist")


def shard_state(state: LBFGSState, mesh) -> LBFGSState:
    """This rank's shard of a whole single-instance state (``dist.mesh.Mesh``):
    x, g and the ring's columns are zero-padded to a multiple of the mesh's
    size and cut to the rank's block; every other field is replicated as it
    is.  With ``state_from_numpy`` this starts the port's sharded solver from
    a reference state."""
    from .dist.mesh import local_block, pad_for_mesh

    if mesh.size == 1:
        return state
    return state.replace(**{
        name: local_block(pad_for_mesh(getattr(state, name), mesh.size)[0],
                          mesh)
        for name in _SHARDED_FIELDS})


def gather_state(state: LBFGSState, mesh, d: int) -> LBFGSState:
    """The whole unpadded state, on every rank, from each rank's shard (one
    collective per sharded field): the inverse of ``shard_state``, for
    ``state_to_numpy`` and the reference's field layout.  A bfloat16 ring
    crosses the group as float32 (exact)."""
    if mesh.comm is None:
        return state

    def whole(t):
        wide = t.float() if t.dtype == torch.bfloat16 else t
        # (size * d_local,) for a vector; the ring gathers column blocks.
        parts = mesh.comm.all_gather_vec(wide.unsqueeze(0))
        out = torch.cat(parts.unbind(0), dim=-1)[..., :d]
        return out.to(t.dtype)

    return state.replace(**{name: whole(getattr(state, name))
                            for name in _SHARDED_FIELDS})
