"""A caller's own whole-vector objective on one shard of a sharded solve,
partitioned by DTensor (``torch.distributed.tensor``): the counterpart of
the reference handing a jnp ``f`` to XLA's SPMD partitioner
(``tpu_lbfgs/dist/sharded.py:117``, ``:219``).

The rank's block of the zero-padded x becomes its shard of a DTensor over
the rank's d group, ``Shard`` on the vector axis; the caller's ``f`` runs on
it as on a whole (d,) or (B, d) tensor, DTensor inserts the collectives its
operations need (a shifted slice all-gathers, a sum all-reduces), and
autograd takes the gradient back to the rank's block.  The padded
coordinates stay invisible: the DTensor has the unpadded global length n,
and its uneven ``Shard`` layout (chunks of ceil(n / size)) is exactly the
padded blocks' real elements, so a rank hands over its block without the
padding and gets zero gradient there.

DTensor does not carry an in-place write into a slice of a sharded tensor
back to that tensor (``g = zeros_like(x); g[..., :-1] += ...`` leaves g's
shards as they were: the slice is a redistributed copy), so the caller's
``f`` must be written without such writes, as a jnp ``f`` is by
construction.  Hand-written gradients and polynomials often write into
slices (the suite's do), so the caller's ``grad``, ``value_and_grad`` and
``dir_poly`` run on the whole vector, gathered to every rank (one
all-gather of x, and of d for ``dir_poly``), and the rank keeps its block.

The collectives of one evaluation are DTensor's, not ``comm.ShardComm``'s:
``CommDebugMode`` (``torch.distributed.tensor.debug``) counts them.

DTensor calls PyTorch's functional collectives, whose native forms run
asynchronously, and these fail on both of the port's devices.  gloo has
CUDA tensors for ``all_reduce`` and ``all_gather_into_tensor`` through the
host, which is how several ranks share one card, but the native forms end
the process on a CUDA tensor in a gloo group.  On CPU tensors, with
several in flight on one gloo group (an objective may ask DTensor for
asynchronous redistributions), a gloo worker finds the heap corrupted and
aborts the rank (``malloc(): unaligned tcache chunk detected``), and
rarely so even one at a time, as DTensor's own redistributions run
(``torch_records/gloo_inflight.py`` runs each route alone,
``torch_records/spawn_steadiness.py --own`` the solves where a rank
died).  So ``_device_mesh`` registers them, for the mesh's device
type whatever it is, as synchronous calls of the ``torch.distributed``
API, which every backend has (``_c10d_api_collectives``): the same values,
the same solve bit for bit, and the same route on the CPU as on the card.
The registration holds for the whole process until ``release``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import Tensor

from .mesh import Mesh

#: The registration that keeps ``_c10d_api_collectives`` alive, by
#: dispatch key.
_LIBS: dict = {}
#: The DeviceMeshes of ``_device_mesh``, by (group, device type).
_MESHES: dict = {}


def _reduce(t: Tensor, op: str, group) -> Tensor:
    """``t`` summed (or reduced by ``op``) over ``group`` in place."""
    if op == "avg":
        dist.all_reduce(t, dist.ReduceOp.SUM, group=group)
        return t.div_(dist.get_world_size(group))
    dist.all_reduce(t, getattr(dist.ReduceOp, op.upper()), group=group)
    return t


def _c10d_api_collectives(key: str) -> None:
    """Register the functional collectives DTensor uses for tensors of
    dispatch key ``key`` ("CPU", "CUDA") as synchronous
    ``torch.distributed`` calls (see the module docstring).  Once per
    process and key."""
    if key in _LIBS:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_reduce(t, op, name):
        return _reduce(t.clone(memory_format=torch.contiguous_format), op,
                       _resolve_process_group(name))

    def all_reduce_(t, op, name):
        return _reduce(t, op, _resolve_process_group(name))

    def all_gather(t, size, name):
        t = t.contiguous()
        out = t.new_empty((size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t,
                                    group=_resolve_process_group(name))
        return out

    def reduce_scatter(t, op, size, name):
        group = _resolve_process_group(name)
        full = all_reduce(t, op, name)
        return full.chunk(size)[dist.get_rank(group)].clone()

    lib = torch.library.Library("_c10d_functional", "IMPL")
    impls = {
        "all_reduce": all_reduce,
        "all_reduce_": all_reduce_,
        "all_reduce_coalesced": lambda ts, op, name: [
            all_reduce(t, op, name) for t in ts],
        "all_gather_into_tensor": all_gather,
        "all_gather_into_tensor_coalesced": lambda ts, size, name: [
            all_gather(t, size, name) for t in ts],
        "reduce_scatter_tensor": reduce_scatter,
        "reduce_scatter_tensor_coalesced": lambda ts, op, size, name: [
            reduce_scatter(t, op, size, name) for t in ts],
        "wait_tensor": lambda t: t,
    }
    for op, fn in impls.items():
        lib.impl(op, fn, key)
    _LIBS[key] = lib


def _device_mesh(group, device_type: str):
    """The 1-D DeviceMesh over an existing process group (None: the
    default one), built once per group and device type; built from the
    port's own group, so a gloo group stays gloo where
    ``init_device_mesh("cuda")`` would pick nccl, which refuses several
    ranks on one card.  The functional collectives of the device type are
    the synchronous ones before DTensor first runs on it."""
    key = (group, device_type)
    if key not in _MESHES:
        from torch.distributed.device_mesh import DeviceMesh

        _c10d_api_collectives(device_type.upper())
        _MESHES[key] = DeviceMesh.from_group(
            group if group is not None else dist.group.WORLD,
            device_type=device_type)
    return _MESHES[key]


def release() -> None:
    """Let go of every process group this module holds, before the groups
    are destroyed (``multihost.shutdown`` calls it).  A DeviceMesh keeps
    its groups (``_pg_registry``), and DTensor's own caches keep the meshes
    of the specs they saw for as long as the process lives, so without
    this ``destroy_process_group`` leaves the groups alive and their
    backend's threads running into interpreter exit.  Also drops the
    registrations of ``_c10d_api_collectives``, so that the functional
    collectives are PyTorch's own again."""
    for mesh in _MESHES.values():
        getattr(mesh, "_pg_registry", {}).clear()
    _MESHES.clear()
    for lib in _LIBS.values():
        lib._destroy()
    _LIBS.clear()


class Partitioner:
    """Turns this rank's blocks into DTensors of the unpadded global
    vector and back.  ``mesh``: the rank's place (its d group); ``n``: the
    global unpadded length."""

    def __init__(self, mesh: Mesh, n: int):
        self.comm = mesh.comm
        self.rank, self.size, self.n = mesh.rank, mesh.size, n
        if self.comm.order != sorted(self.comm.order):
            # DTensor places shard r on the group's rank r.
            raise ValueError(
                "a caller's own objective needs the mesh in its group's "
                "rank order (make_mesh); this mesh reorders the ranks by "
                "host")

    def _real(self, d_local: int) -> int:
        """This rank's elements of the unpadded vector."""
        return max(0, min(d_local, self.n - self.rank * d_local))

    def wrap(self, x_local: Tensor):
        """The DTensor whose shard on this rank is ``x_local`` (..., d_local)
        without its padding: global shape (..., n), ``Shard`` on the last
        axis."""
        from torch.distributed.tensor import DTensor, Shard

        real = self._real(x_local.shape[-1])
        shape = tuple(x_local.shape[:-1]) + (self.n,)
        stride = torch.empty(shape, device="meta").stride()
        block = x_local[..., :real]
        if not block.is_contiguous():
            block = block.contiguous()
        return DTensor.from_local(
            block, _device_mesh(self.comm.group, x_local.device.type),
            [Shard(x_local.dim() - 1)], run_check=False, shape=shape,
            stride=stride)

    def gathered(self, x_local: Tensor) -> Tensor:
        """The whole unpadded (..., n) vector on every rank, as a plain
        tensor (one all-gather)."""
        return self.wrap(x_local).full_tensor()

    @staticmethod
    def whole(v) -> Tensor:
        """A DTensor result (a value, polynomial coefficients) as the
        replicated tensor on every rank."""
        from torch.distributed.tensor import DTensor

        return v.full_tensor() if isinstance(v, DTensor) else v

    def block(self, g: Tensor, d_local: int) -> Tensor:
        """This rank's (..., d_local) block of a whole (..., n) gradient,
        zero in the padding."""
        start = self.rank * d_local
        g = g[..., start:start + self._real(d_local)]
        pad = d_local - g.shape[-1]
        return torch.nn.functional.pad(g, (0, pad)) if pad else g


def partitioned_value(f: Callable, mesh: Mesh, n: int) -> Callable:
    """f_local(x_local) -> f, replicated: the caller's whole-vector ``f``
    on the DTensor of this rank's block."""
    part = Partitioner(mesh, n)

    def f_local(x):
        return part.whole(f(part.wrap(x)))

    return f_local


def partitioned_value_and_grad(f: Callable, mesh: Mesh, n: int, grad=None,
                               value_and_grad=None) -> Callable:
    """vg(x_local) -> (f replicated, g_local): the caller's
    ``value_and_grad`` on the gathered whole vector, else ``f`` on the
    DTensor with its ``grad`` on the gathered whole vector, else ``f`` with
    its gradient by autograd through the DTensor (``make_value_and_grad``'s
    order; the module docstring says why the hand-written callables see the
    whole vector)."""
    part = Partitioner(mesh, n)

    def vg(x):
        d_local = x.shape[-1]
        if value_and_grad is not None:
            val, g = value_and_grad(part.gathered(x))
        elif grad is not None:
            val, g = f(part.wrap(x)), grad(part.gathered(x))
        else:
            with torch.enable_grad():
                leaf = x.detach().requires_grad_(True)
                val = part.whole(f(part.wrap(leaf)))
                (g,) = torch.autograd.grad(val.sum(), leaf)
            return val.detach(), g
        return part.whole(val), part.block(g, d_local)

    return vg


def partitioned_dir_poly(dir_poly: Optional[Callable], mesh: Mesh,
                         n: int) -> Optional[Callable]:
    """dir_poly_local(x_local, d_local) -> the replicated coefficients of
    the caller's whole-vector ``dir_poly`` on x and d gathered whole."""
    if dir_poly is None:
        return None
    part = Partitioner(mesh, n)

    def poly(x, d):
        return dir_poly(part.gathered(x), part.gathered(d))

    return poly
