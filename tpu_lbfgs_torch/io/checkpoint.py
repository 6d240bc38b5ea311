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

The per-shard layout (``save_state_sharded`` / ``load_state_sharded``),
the reference's contract (``tpu_lbfgs/io/checkpoint.py:119-349``) for the
port's explicit SPMD: every rank of a sharded solve writes its own block
(``shard-<rank>.npz``: its chunk of every field, with the chunk's place in
the global padded arrays), a barrier, and rank 0 publishes ``index.json``
by ``os.replace``, the commit marker; the replicated fields (scalars, the
(m,) and (m, m) ring metadata) are in every file.  A directory without
``index.json`` is a torn save and is refused.  Loading rebuilds each
rank's block from the chunks that intersect it, so the restoring mesh may
differ from the saving one (4 ranks saved, 2 or 1 loading): the padding
beyond the unpadded d, which the index records, is zeros, as the solver
keeps it.  ``dist.sharded.solve_shard_from_state`` resumes from the
loaded state.
"""
from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path

import numpy as np
import torch

from ..interop import state_from_numpy, state_to_numpy
from ..types import Guard, LBFGSState, resolve_device

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


# --- the per-rank layout of a sharded solve ---------------------------------

_SCHEMA_SHARDED = "tpu-lbfgs-state-sharded-v1"
#: Fields whose last axis is the vector axis, split over the d group.
_D_FIELDS = ("x", "g", "s_hist", "y_hist")


def _place(mesh, name: str, local_shape, d_global: int, batched: bool):
    """[[start, stop], ...] of this rank's chunk of field ``name`` in the
    global arrays: its row's lanes on axis 0 of a batch, its block of the
    (padded) vector on the last axis of a d field, whole elsewhere."""
    idx = [[0, int(n)] for n in local_shape]
    if batched:
        b = int(local_shape[0])
        idx[0] = [mesh.batch_rank * b, (mesh.batch_rank + 1) * b]
    if name in _D_FIELDS:
        d_local = -(-d_global // mesh.size)
        idx[-1] = [mesh.rank * d_local, (mesh.rank + 1) * d_local]
    return idx


def _process():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.barrier
    return 0, 1, lambda: None


def save_state_sharded(dir_path, state: LBFGSState, mesh=None,
                       d: int = None) -> None:
    """Write this rank's part of a sharded solve's ``state`` under
    ``dir_path``: collective, every rank of ``mesh`` (default
    ``dist.make_mesh()``) calls it with the same directory.  ``d``: the
    unpadded global length (default: the padded one).  The state is copied
    to the host first, so the solve may go on with it; a bfloat16 ring is
    stored as its float32 values and narrowed back exactly on load."""
    from ..dist.mesh import make_mesh

    mesh = mesh if mesh is not None else make_mesh()
    proc, nproc, barrier = _process()
    dir_path = Path(dir_path)
    dir_path.mkdir(parents=True, exist_ok=True)
    batched = state.x.dim() == 2
    d_pad = state.x.shape[-1] * mesh.size
    d = d_pad if d is None else int(d)
    arrays, casts, chunks, fields = {}, {}, {}, {}
    for name in _FIELDS:
        t = getattr(state, name).detach()
        key = f"{name}__p{proc}"
        if t.dtype == torch.bfloat16:
            casts[key] = "bfloat16"
            t = t.float()                   # exact
        arrays[key] = t.cpu().numpy().copy()
        idx = _place(mesh, name, t.shape, d_pad, batched)
        chunks[name] = [{"key": key, "index": idx}]
        shape = list(t.shape)
        if batched:
            shape[0] *= mesh.batch_size
        if name in _D_FIELDS:
            shape[-1] = d_pad
        fields[name] = {"shape": shape, "dtype": casts.get(
            key, str(arrays[key].dtype))}
    path = dir_path / f"shard-{proc}.npz"
    tmp = path.with_suffix(".npz.tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, __schema__=np.asarray(_SCHEMA_SHARDED),
                 __casts__=np.asarray(json.dumps(casts)),
                 __chunks__=np.asarray(json.dumps(chunks)), **arrays)
    os.replace(tmp, path)
    # Every rank's file is written before rank 0 publishes the commit
    # marker, and no rank returns (and may load) before it exists.
    barrier()
    if proc == 0:
        # A file from an earlier save with more ranks would cover the same
        # global slices with old data: removed before the commit.
        for stale in dir_path.glob("shard-*.npz"):
            tail = stale.stem.split("-", 1)[1]
            if tail.isdigit() and int(tail) >= nproc:
                stale.unlink()
        index = {"schema": _SCHEMA_SHARDED, "num_processes": nproc,
                 "d": d, "fields": fields}
        tmp_idx = dir_path / "index.json.tmp"
        tmp_idx.write_text(json.dumps(index, indent=1))
        os.replace(tmp_idx, dir_path / "index.json")
    barrier()


def load_state_sharded(dir_path, mesh=None, device=None) -> LBFGSState:
    """This rank's state on ``mesh`` (default ``dist.make_mesh()``; one
    process: the whole state) from a ``save_state_sharded`` directory, on
    ``device`` (``types.resolve_device``: the current CUDA device unless
    "cpu" is asked for).  Each block is assembled from the saved chunks it
    intersects, zero beyond the unpadded d, so the mesh may differ from the
    saving one.  Raises as the reference does: ``FileNotFoundError`` without
    ``index.json`` (a torn save) or with a committed file missing,
    ``ValueError`` for files beyond the index's count (stale leftovers) or
    chunks that do not cover the block."""
    from ..dist.mesh import make_mesh

    mesh = mesh if mesh is not None else make_mesh()
    dir_path = Path(dir_path)
    index = json.loads((dir_path / "index.json").read_text())
    if index.get("schema") != _SCHEMA_SHARDED:
        raise ValueError(f"unknown sharded-checkpoint schema "
                         f"{index.get('schema')!r}")
    nproc = int(index["num_processes"])
    files = [dir_path / f"shard-{p}.npz" for p in range(nproc)]
    missing = [str(p) for p in files if not p.exists()]
    if missing:
        raise FileNotFoundError(
            f"sharded checkpoint {dir_path} is missing committed shard "
            f"files {missing} (index.json says num_processes={nproc})")
    extras = sorted(set(dir_path.glob("shard-*.npz")) - set(files))
    if extras:
        raise ValueError(
            f"sharded checkpoint {dir_path} contains shard files beyond "
            f"index.json's num_processes={nproc}: "
            f"{[p.name for p in extras]}; stale leftovers from an earlier "
            f"save with more processes")
    d = int(index["d"])
    fields = index["fields"]
    batched = len(fields["x"]["shape"]) == 2
    d_pad = -(-d // mesh.size) * mesh.size
    dev = resolve_device(device)
    out = {}
    handles = [np.load(p, allow_pickle=False) for p in files]
    try:
        chunks = {}
        for z in handles:
            for name, cs in json.loads(str(z["__chunks__"])).items():
                chunks.setdefault(name, []).extend((z, c) for c in cs)
        for name in _FIELDS:
            meta = fields[name]
            shape = list(meta["shape"])
            if batched:
                shape[0] //= mesh.batch_size
            if name in _D_FIELDS:
                shape[-1] = d_pad // mesh.size
            req = _place(mesh, name, shape, d_pad, batched)
            wide = "float32" if meta["dtype"] == "bfloat16" else meta["dtype"]
            block = np.zeros(shape, dtype=wide)
            filled = np.zeros(shape, dtype=bool)
            for z, c in chunks.get(name, []):
                inter = [[max(a0, b0), min(a1, b1)]
                         for (a0, a1), (b0, b1) in zip(c["index"], req)]
                if any(lo >= hi for lo, hi in inter):
                    continue
                src = tuple(slice(lo - c0, hi - c0)
                            for (lo, hi), (c0, _) in zip(inter, c["index"]))
                dst = tuple(slice(lo - r0, hi - r0)
                            for (lo, hi), (r0, _) in zip(inter, req))
                block[dst] = z[c["key"]][src]
                filled[dst] = True
            need = filled
            if name in _D_FIELDS:
                # Beyond the unpadded d the block is padding: zeros.
                start = req[-1][0]
                need = filled | (np.arange(start, start + shape[-1]) >= d)
            if not need.all():
                raise ValueError(
                    f"sharded checkpoint does not cover slice {req} of field "
                    f"{name} with shape {meta['shape']}")
            t = torch.from_numpy(block).to(dev)
            if meta["dtype"] == "bfloat16":
                t = t.to(torch.bfloat16)    # exact: the values were bf16
            out[name] = t
    finally:
        for z in handles:
            z.close()
    if out["guards"].shape[-1] < Guard.N:
        out["guards"] = torch.nn.functional.pad(
            out["guards"], (0, Guard.N - out["guards"].shape[-1]))
    return LBFGSState(**out)
