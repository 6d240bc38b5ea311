"""Hand-written CUDA kernels of the solver's iteration, each beside its
plain PyTorch version.

  fused_vg                f and the analytic gradient of a suite problem in
                          one read of x (csrc/fused_vg.cu; replaces the Pallas
                          _vg_quadratic_kernel, _vg_rosenbrock_kernel and
                          _vg_coupled_kernel).
  make_fused_tail         the post-line-search tail of a suite problem in one
                          pass over x, d, g, optionally with the history
                          products t1 = S y, t2 = Y y, compensated sums and
                          bfloat16 ring rows (csrc/fused_tail.cu; replaces
                          the Pallas _make_tail_kernel with each body of
                          TAIL_BODIES).
  iteration_tail          the tail of any objective, given its new gradient:
                          x_new, s, y and five sums in one pass
                          (csrc/iteration_tail.cu; replaces the Pallas
                          _make_iteration_tail_kernel, plain and compensated).
  combine_direction       r = gamma g + v S - gamma u Y in one stream over
                          the history, float32, float64 or a bfloat16 ring
                          under float32 (csrc/combine_direction.cu; replaces
                          the Pallas _combine_kernel).

The problem-specific kernels are templates on the problem's body
(csrc/bodies.cuh): ``quadratic``, ``rosenbrock`` and ``coupled_quadratic``,
the reference's FUSED_VG / TAIL_BODIES.  ``sphere`` has no body there and
none here.

A kernel and its plain version form each sum from the same terms in the
working dtype, accumulate in float64 and round once to the working dtype,
so the two differ only by the order of float64 additions.

The four whole-vector families take one instance or a batch, as the
reference's kernels take one vector or, under ``jax.vmap``, a grid axis
per lane (the shard-local forms too, below): one
contiguous ``(d,)`` vector, or a leading lane axis of contiguous rows,
``(B, d)`` (a ring ``(B, m, d)``, ``v`` and ``u`` ``(B, m)``), with one
``alpha`` or ``gamma`` per lane and every sum per lane, ``(B,)`` (``t1``,
``t2`` ``(B, m)``).  A batch launches the kernel's batched form
(``tl_*_batched_*``): each lane is a row of its own, its chain ends at its
row's ends, and each lane's sums are added from that lane's block partials
alone.  The plain versions take the same ``(..., d)`` shapes with every
sum over the last axis, and a batch's rows equal the same call on each row
alone bit for bit.

A wrapper takes its plain version only for tensors on the CPU, where the
tests run (or where the caller passes ``use_pallas=False``, the
reference's switch).  A CUDA tensor launches the kernel, and anything else
raises: a wrapper never leaves a tensor on the card to the plain version
by itself.  The problem-specific kernels (fused_vg, the fused tail, and
the K-trial evaluators of ``line_search_ops``) are float32 programs; the
two general kernels are built for float32 and float64.  ``pallas_ok`` is
the reference's dtype rule of that name, for the callers that know the
iterate's dtype before they build their callables (the command line,
``bench_gpu``, ``sharded_minimize``): they pass ``use_pallas=False``
themselves for a dtype the kernels are not built for, with a warning, and
the same on either device.  ``launches`` counts each wrapper's kernel
launches, so a run can show that it went through the kernels.

The four problem-specific families also have a shard-local form for the
sharded solve (``dist.pallas_sharded``): the same kernels on one shard's
block with the global unpadded length ``n``, the shard's global offset
``start`` and the neighbouring shards' boundary elements ``edges`` (a
device tensor), owning terms by global index and returning their sums as
float64, unrounded, for one packed all-reduce.  ``local_fused_vg`` and
``local_fused_tail`` are their wrappers here, beside the plain versions
``dist.shardmap_vg.local_vg_plain`` and ``fused_tail_local_plain``.  A
shard-local form takes a batch as well (``sharded_vmap_minimize``): (B,
d_local) rows of one shard that share ``n`` and ``start``, ``edges`` as
(B, count) rows, one per lane, and every sum per lane; on the card it
launches the batched shard-local kernel (``tl_*_local_batched_f32``), once
for all lanes.  The plain versions form their float64 sums as products
summed over the last axis, never through a BLAS call, so a batch's rows
equal the same call on each row alone bit for bit.
"""
from __future__ import annotations

import torch
from torch import Tensor

from ..types import per_lane
from ..utils.accurate import compensated_dot
from . import _build, counts

#: The body ids of csrc/bodies.cuh, by problem name.
BODY_IDS = {"quadratic": 0, "rosenbrock": 1, "coupled_quadratic": 2}

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {**{f"{name}_vg": 0 for name in BODY_IDS},
            **{f"{name}_fused_tail": 0 for name in BODY_IDS},
            **{f"{name}_vg_local": 0 for name in BODY_IDS},
            **{f"{name}_fused_tail_local": 0 for name in BODY_IDS},
            "iteration_tail": 0, "combine_direction": 0,
            **{f"{name}_vg_batched": 0 for name in BODY_IDS},
            **{f"{name}_fused_tail_batched": 0 for name in BODY_IDS},
            "iteration_tail_batched": 0, "combine_direction_batched": 0,
            **{f"{name}_vg_local_batched": 0 for name in BODY_IDS},
            **{f"{name}_fused_tail_local_batched": 0 for name in BODY_IDS}}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_vec(name: str, t: Tensor, shape: tuple, dtype=torch.float32,
               like: Tensor = None) -> None:
    """Raise unless t is a contiguous CUDA tensor of ``shape`` and
    ``dtype``, on like's device where like is given."""
    if t.device.type != "cuda" or (like is not None
                                   and t.device != like.device):
        raise ValueError(f"{name}: expected a CUDA tensor"
                         + (f" on {like.device}" if like is not None else "")
                         + f", got {t.device}")
    if t.dtype != dtype:
        raise TypeError(
            f"{name}: the CUDA kernel takes {dtype} here, got {t.dtype}")
    if t.shape != shape or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous {tuple(shape)} "
                         f"tensor, got shape {tuple(t.shape)}, strides "
                         f"{t.stride()}")


def _lanes(x: Tensor):
    """None for one instance, a (d,) vector; B for a batch, (B, d) rows;
    raises for any other rank."""
    if x.dim() == 1:
        return None
    if x.dim() == 2:
        return x.shape[0]
    raise ValueError(f"x: the kernels take a (d,) vector or (B, d) rows, got "
                     f"shape {tuple(x.shape)}")


def _check_per_lane(name: str, t: Tensor, lanes, like: Tensor) -> None:
    """Raise unless t holds one ``like.dtype`` value per lane (one for one
    instance), contiguous, on like's device."""
    count = 1 if lanes is None else lanes
    if (t.device != like.device or t.dtype != like.dtype
            or t.numel() != count or not t.is_contiguous()):
        raise ValueError(f"{name}: expected {count} contiguous {like.dtype} "
                         f"value(s) on {like.device}, one per lane, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def pallas_ok(dtype) -> bool:
    """Whether the problem-specific kernels are built for iterates of
    ``dtype``: float32 only (the reference's ``pallas_ok``: its kernels are
    float32 programs and everything else goes its jnp route).  A rule for
    the caller that chooses ``use_pallas``; the wrappers themselves raise
    for another dtype on the card."""
    return dtype == torch.float32


def _kernel_dtype(name: str, t: Tensor) -> str:
    """The entry-point suffix for t's dtype; raises for a dtype the two
    general kernels are not built for."""
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name}: the CUDA kernel takes float32 or float64, "
                        f"got {t.dtype}")
    return _SUFFIX[t.dtype]


def _sum(t: Tensor) -> Tensor:
    return torch.sum(t, dim=-1, dtype=torch.float64).to(t.dtype)


def _vdot(a: Tensor, b: Tensor) -> Tensor:
    """a . b over the last axis, in the working dtype."""
    return torch.dot(a, b) if a.dim() == 1 else torch.linalg.vecdot(a, b)


def _rdot(comm, a: Tensor, b: Tensor) -> Tensor:
    """a . b over the whole vector axis: ``_vdot`` without a comm; with one
    (``dist.comm.ShardComm``), this shard's float64 partial summed over the
    group and rounded once to a's dtype, a lane's each for a batch, all in
    one all-reduce."""
    if comm is None:
        return _vdot(a, b)
    return comm.reduce_parts([_vdot(a.double(), b.double())], a.dtype)[0]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """a . b over the last axis, accumulated in float64."""
    return _vdot(a.double(), b.double()).to(a.dtype)


# --- value and gradient -----------------------------------------------------

def quadratic_f_plain(x: Tensor) -> Tensor:
    """sum (x_i - 1)^2 over the last axis, its terms summed in float64 (the
    kernels' convention)."""
    r = x - 1.0
    return _sum(r * r)


def quadratic_vg_plain(x: Tensor) -> tuple[Tensor, Tensor]:
    """The quadratic's f and gradient from plain tensor ops (the
    reference's jnp fallback of fused_vg_quadratic)."""
    r = x - 1.0
    return _sum(r * r), 2.0 * r


def rosenbrock_grad_plain(x: Tensor) -> Tensor:
    """The analytic gradient of chained Rosenbrock over the last axis."""
    xi, xn = x[..., :-1], x[..., 1:]
    t1 = xn - xi * xi
    g = torch.zeros_like(x)
    g[..., :-1] += 2.0 * (xi - 1.0) - 400.0 * xi * t1
    g[..., 1:] += 200.0 * t1
    return g


def rosenbrock_f_plain(x: Tensor) -> Tensor:
    """Chained Rosenbrock f over the last axis, its float32 terms summed in
    float64 (the kernels' convention)."""
    xi, xn = x[..., :-1], x[..., 1:]
    t1 = xn - xi * xi
    t2 = 1.0 - xi
    return _sum(100.0 * t1 * t1 + t2 * t2)


def rosenbrock_vg_plain(x: Tensor) -> tuple[Tensor, Tensor]:
    """Chained Rosenbrock f and gradient from plain tensor ops (the
    reference's jnp fallback of fused_vg_rosenbrock)."""
    return rosenbrock_f_plain(x), rosenbrock_grad_plain(x)


def coupled_f_plain(x: Tensor) -> Tensor:
    """The coupled quadratic (coefficient 1000) over the last axis, one term
    per element as the kernels form it, 1000 x_i^2 + 100 x_i x_{i+1}, summed
    in float64."""
    t = 1000.0 * x * x
    t[..., :-1] += 100.0 * (x[..., :-1] * x[..., 1:])
    return _sum(t)


def coupled_grad_plain(x: Tensor) -> Tensor:
    """The coupled quadratic's gradient over the last axis:
    (2000 x_i + 100 x_{i+1}) + 100 x_{i-1}."""
    g = 2000.0 * x
    g[..., :-1] += 100.0 * x[..., 1:]
    g[..., 1:] += 100.0 * x[..., :-1]
    return g


def coupled_vg_plain(x: Tensor) -> tuple[Tensor, Tensor]:
    """The coupled quadratic's f and gradient from plain tensor ops (the
    reference's jnp fallback of fused_vg_coupled_quadratic)."""
    return coupled_f_plain(x), coupled_grad_plain(x)


#: Plain f and (f, g) per problem with a kernel body: the kernels' terms in
#: the kernels' order.
F_PLAIN = {"quadratic": quadratic_f_plain, "rosenbrock": rosenbrock_f_plain,
           "coupled_quadratic": coupled_f_plain}
VG_PLAIN = {"quadratic": quadratic_vg_plain,
            "rosenbrock": rosenbrock_vg_plain,
            "coupled_quadratic": coupled_vg_plain}


def fused_vg(problem: str, x: Tensor,
             use_pallas: bool = True) -> tuple[Tensor, Tensor]:
    """(f, g) of a suite problem with a kernel body: the CUDA kernel for a
    float32 CUDA tensor, a (d,) vector or (B, d) rows with f (B,) (any
    other tensor on the card raises), the plain version for a CPU tensor or
    under ``use_pallas=False``."""
    if not use_pallas or x.device.type == "cpu":
        return VG_PLAIN[problem](x)
    _check_vec("x", x, x.shape)
    lanes, n = _lanes(x), x.shape[-1]
    lib = _build.load()
    g = torch.empty_like(x)
    partials = torch.empty(lib.tl_max_blocks() + (lanes or 0),
                           dtype=torch.float64, device=x.device)
    f = torch.empty(lanes or 1, dtype=torch.float32, device=x.device)
    head = (BODY_IDS[problem], x.data_ptr(), g.data_ptr(),
            partials.data_ptr(), f.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lanes is None:
            name = f"{problem}_vg"
            err = lib.tl_fused_vg_f32(*head, n, stream)
        else:
            name = f"{problem}_vg_batched"
            err = lib.tl_fused_vg_batched_f32(*head, lanes, n, stream)
    _build.check(lib, err, name)
    counts.count(launches, name)
    return (f[0] if lanes is None else f), g


def _check_edges(edges: Tensor, count: int, x: Tensor, lanes=None) -> None:
    """Raise unless edges holds ``count`` float32 values, (count,) for one
    instance or (lanes, count) for a batch, contiguous on x's device."""
    shape = (count,) if lanes is None else (lanes, count)
    if (edges.device != x.device or edges.dtype != torch.float32
            or edges.shape != shape or not edges.is_contiguous()):
        raise ValueError(f"edges: expected a contiguous {shape} float32 "
                         f"tensor on {x.device}, got {edges.dtype} "
                         f"{tuple(edges.shape)} on {edges.device}")


def local_fused_vg(problem: str, x_local: Tensor, n: int, start: int,
                   edges: Tensor,
                   use_pallas: bool = True) -> tuple[Tensor, Tensor]:
    """Shard-local fused value and gradient, with the reference's
    signature: (float64 partial of f, for the caller's all-reduce; the
    local gradient block).  ``n`` is the global unpadded length, ``start``
    this shard's global offset, ``edges`` = [previous shard's last x, next
    shard's first x] on x's device.  A batch, (B, d_local) rows with (B, 2)
    edges, gives a partial per lane, (B,).  The CUDA kernel for a float32
    CUDA block (any other block on the card raises), the plain version
    (``dist.shardmap_vg.local_vg_plain``) for a CPU tensor or under
    ``use_pallas=False``."""
    if not use_pallas or x_local.device.type == "cpu":
        from ..dist.shardmap_vg import local_vg_plain
        return local_vg_plain(problem, x_local, n, start, edges)
    lanes, n_local = _lanes(x_local), x_local.shape[-1]
    _check_vec("x_local", x_local, x_local.shape)
    _check_edges(edges, 2, x_local, lanes)
    lib = _build.load()
    g = torch.empty_like(x_local)
    partials = torch.empty(lib.tl_max_blocks() + (lanes or 0),
                           dtype=torch.float64, device=x_local.device)
    f = torch.empty(lanes or 1, dtype=torch.float64, device=x_local.device)
    head = (BODY_IDS[problem], x_local.data_ptr(), g.data_ptr(),
            partials.data_ptr(), f.data_ptr())
    tail = (n, start, edges.data_ptr())
    with torch.cuda.device(x_local.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lanes is None:
            name = f"{problem}_vg_local"
            err = lib.tl_fused_vg_local_f32(*head, n_local, *tail, stream)
        else:
            name = f"{problem}_vg_local_batched"
            err = lib.tl_fused_vg_local_batched_f32(*head, lanes, n_local,
                                                    *tail, stream)
    _build.check(lib, err, name)
    counts.count(launches, name)
    return (f[0] if lanes is None else f), g


def fused_vg_quadratic(x: Tensor, use_pallas: bool = True):
    """``fused_vg`` of the quadratic, with the reference's signature."""
    return fused_vg("quadratic", x, use_pallas)


def fused_vg_rosenbrock(x: Tensor, use_pallas: bool = True):
    """``fused_vg`` of chained Rosenbrock, with the reference's signature."""
    return fused_vg("rosenbrock", x, use_pallas)


def fused_vg_coupled_quadratic(x: Tensor, use_pallas: bool = True):
    """``fused_vg`` of the coupled quadratic, with the reference's
    signature."""
    return fused_vg("coupled_quadratic", x, use_pallas)


#: The reference's FUSED_VG: the fused value-and-gradient per problem.
FUSED_VG = {"quadratic": fused_vg_quadratic,
            "rosenbrock": fused_vg_rosenbrock,
            "coupled_quadratic": fused_vg_coupled_quadratic}


# --- fused iteration tail ---------------------------------------------------

def _ring_matvec(hist: Tensor, v: Tensor) -> Tensor:
    """hist (..., m, d) times v (..., d) in v's dtype, every product formed
    and added in float64 (a bfloat16 ring is widened, never multiplied in
    bfloat16)."""
    out = torch.matmul(hist.double(), v.double().unsqueeze(-1)).squeeze(-1)
    return out.to(v.dtype)


def fused_tail_plain(vg_fn, x: Tensor, d: Tensor, alpha: Tensor, g: Tensor,
                     s_hist=None, y_hist=None, with_matvec: bool = False,
                     accurate: bool = False):
    """The tail from plain tensor ops and any value-and-gradient function
    (the reference's fused_tail_jnp).  Returns (x_new, f_new, g_new, s_row,
    y_row, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new, t1, t2).  The
    two rows are cast to the history's dtype (x's when no history is given).
    ``with_matvec`` adds t1 = S y and t2 = Y y over the ring as it is given,
    against the raw y, else they are None and the ring is not read.
    ``accurate`` takes the six dots through
    ``utils.accurate.compensated_dot``, all in one call; f is ``vg_fn``'s.
    Batched, ``alpha`` holds one step per lane."""
    s = per_lane(alpha) * d
    x_new = x + s
    f_new, g_new = vg_fn(x_new)
    y = g_new - g
    if accurate:
        dots = compensated_dot(torch.stack([s, y, g_new, d, g, y]),
                               torch.stack([y, y, g_new, g_new, g_new,
                                            g_new])).unbind(0)
    else:
        dots = (_dot(s, y), _dot(y, y), _dot(g_new, g_new), _dot(d, g_new),
                _dot(g, g_new), _dot(y, g_new))
    t1 = t2 = None
    if with_matvec:
        t1, t2 = _ring_matvec(s_hist, y), _ring_matvec(y_hist, y)
    s_row, y_row = s, y
    if s_hist is not None and s_hist.dtype != x.dtype:
        s_row, y_row = s.to(s_hist.dtype), y.to(s_hist.dtype)
    return (x_new, f_new, g_new, s_row, y_row, *dots, t1, t2)


_HIST_DTYPES = (torch.float32, torch.bfloat16)


def _fused_tail_kernel(problem: str, x: Tensor, d: Tensor, alpha: Tensor,
                       g: Tensor, s_hist, y_hist, with_matvec: bool,
                       accurate: bool, shard=None):
    """Launch csrc/fused_tail.cu for CUDA tensors, or raise.  ``shard`` is
    None for the whole vector, else ``(n, start, edges)`` for one shard's
    block: the sums then come back as float64, unrounded, (7 + 2 m,) or
    for a batch (B, 7 + 2 m).  A batch, (B, d) rows with a (B, m, d) ring
    and one alpha per lane, launches the batched form."""
    for name, t in (("x", x), ("d", d), ("g", g)):
        _check_vec(name, t, x.shape, like=x)
    lanes, n = _lanes(x), x.shape[-1]
    _check_per_lane("alpha", alpha, lanes, x)
    hdtype = torch.float32 if s_hist is None else s_hist.dtype
    if hdtype not in _HIST_DTYPES:
        raise TypeError("s_hist: the fused tail kernel takes a float32 or "
                        f"bfloat16 history, got {hdtype}")
    m = 0
    if with_matvec:
        if s_hist is None or y_hist is None:
            raise ValueError("with_matvec needs the history ring")
        m = s_hist.shape[-2]
        if m < 1:
            raise ValueError("with_matvec needs a ring of at least one row")
        ring = x.shape[:-1] + (m, n)
        for name, t in (("s_hist", s_hist), ("y_hist", y_hist)):
            if (t.device != x.device or t.dtype != hdtype
                    or t.shape != ring or not t.is_contiguous()):
                raise ValueError(
                    f"{name}: expected a contiguous {tuple(ring)} {hdtype} "
                    f"tensor on {x.device}, got {t.dtype} shape "
                    f"{tuple(t.shape)}, strides {t.stride()} on {t.device}")
    lib = _build.load()
    x_new, g_new = torch.empty_like(x), torch.empty_like(x)
    s_row, y_row = (torch.empty(x.shape, dtype=hdtype, device=x.device)
                    for _ in range(2))
    n_sums = 7 + 2 * m
    partials = torch.empty(n_sums * (lib.tl_max_blocks() + (lanes or 0)),
                           dtype=torch.float64, device=x.device)
    sums = torch.empty((n_sums,) if lanes is None else (n_sums, lanes),
                       device=x.device,
                       dtype=torch.float32 if shard is None else torch.float64)
    head = (BODY_IDS[problem], int(hdtype == torch.bfloat16), m,
            int(accurate), x.data_ptr(), d.data_ptr(), g.data_ptr(),
            alpha.data_ptr(), s_hist.data_ptr() if m else None,
            y_hist.data_ptr() if m else None, x_new.data_ptr(),
            g_new.data_ptr(), s_row.data_ptr(), y_row.data_ptr(),
            partials.data_ptr(), sums.data_ptr())
    if shard is not None:
        n_global, start, edges = shard
        _check_edges(edges, 4, x, lanes)
        where = (n_global, start, edges.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lanes is not None and shard is None:
            name = f"{problem}_fused_tail_batched"
            err = lib.tl_fused_tail_batched_f32(*head, lanes, n, stream)
        elif lanes is not None:
            name = f"{problem}_fused_tail_local_batched"
            err = lib.tl_fused_tail_local_batched_f32(*head, lanes, n, *where,
                                                      stream)
        elif shard is None:
            name = f"{problem}_fused_tail"
            err = lib.tl_fused_tail_f32(*head, n, stream)
        else:
            name = f"{problem}_fused_tail_local"
            err = lib.tl_fused_tail_local_f32(*head, n, *where, stream)
    _build.check(lib, err, name)
    counts.count(launches, name)
    if shard is not None:
        # A batch's rows (sum, lane), seen as (lane, sum).
        return x_new, g_new, s_row, y_row, (sums if lanes is None
                                            else sums.t())
    t1 = t2 = None
    if m and lanes is None:
        sums, t1, t2 = sums.split((7, m, m))
    elif m:
        # Rows (t1 or t2, k, lane), seen as (B, m) per product.
        t1, t2 = sums[7:].view(2, m, lanes).transpose(1, 2).unbind(0)
        sums = sums[:7]
    f_new, sy, yy, gg, dgn, ggn, ygn = sums.unbind(0)
    return (x_new, f_new, g_new, s_row, y_row, sy, yy, gg, dgn, ggn, ygn,
            t1, t2)


def _rows_dot64(rows: Tensor, v: Tensor) -> Tensor:
    """rows (..., k, d) against v (..., d) in float64, each product formed
    and the row summed over the last axis: the same order for a lane of a
    batch as for that lane alone (a BLAS matrix-vector product would not
    keep it)."""
    return torch.sum(rows.double() * v.double().unsqueeze(-2), dim=-1)


def fused_tail_local_plain(problem: str, x: Tensor, d: Tensor, alpha: Tensor,
                           g: Tensor, s_hist, y_hist, with_matvec: bool,
                           n: int, start: int, edges: Tensor,
                           accurate: bool = False):
    """The shard-local tail from plain tensor ops: (x_new, g_new, s_row,
    y_row, sums) for one shard's block, ``sums`` the float64 partials
    [f, s.y, y.y, g_new.g_new, d.g_new, g.g_new, y.g_new, t1 (m), t2 (m)]
    of the caller's packed all-reduce (t1, t2 only ``with_matvec``).
    ``edges`` = [previous shard's last x and d, next shard's first x and
    d]: the trial point's halos are rebuilt from them as every element's
    is.  ``accurate`` compensates the six dots' local partials
    (``utils.accurate.compensated_dot`` over float64 products).  A batch:
    (B, d_local) rows, a (B, m, d_local) ring, alpha (B,), edges (B, 4),
    sums (B, 7 + 2 m)."""
    from ..dist.shardmap_vg import CHUNKS

    alpha = alpha.reshape(x.shape[:-1])     # one step per lane
    s = alpha.unsqueeze(-1) * d
    x_new = x + s
    prev = edges[..., 0] + alpha * edges[..., 1]
    nxt = edges[..., 2] + alpha * edges[..., 3]
    f_part, g_new = CHUNKS[problem](x_new, prev, nxt, n, start)
    y = g_new - g
    a = torch.stack([s, y, g_new, d, g, y], dim=-2).double()
    b = torch.stack([y, y, g_new, g_new, g_new, g_new], dim=-2).double()
    dots = compensated_dot(a, b) if accurate else torch.sum(a * b, dim=-1)
    parts = [f_part.unsqueeze(-1), dots]
    if with_matvec:
        parts += [_rows_dot64(s_hist, y), _rows_dot64(y_hist, y)]
    s_row, y_row = s, y
    if s_hist is not None and s_hist.dtype != x.dtype:
        s_row, y_row = s.to(s_hist.dtype), y.to(s_hist.dtype)
    return x_new, g_new, s_row, y_row, torch.cat(parts, dim=-1)


def local_fused_tail(problem: str, x: Tensor, d: Tensor, alpha: Tensor,
                     g: Tensor, s_hist, y_hist, with_matvec: bool, n: int,
                     start: int, edges: Tensor, accurate: bool = False,
                     use_pallas: bool = True):
    """The shard-local fused tail (the reference's ``_fused_tail_pallas``
    with ``n``, ``start``, ``edges``): the CUDA kernel for float32 CUDA
    blocks (anything else on the card raises), ``fused_tail_local_plain``
    for CPU tensors or under ``use_pallas=False``.  Returns (x_new, g_new,
    s_row, y_row, float64 sums); a batch takes (B, d_local) rows, a (B, m,
    d_local) ring, one alpha per lane and (B, 4) edges, and gives the sums
    as (B, 7 + 2 m), launching the batched shard-local kernel once."""
    if use_pallas and x.device.type != "cpu":
        return _fused_tail_kernel(problem, x, d, alpha.reshape(-1), g,
                                  s_hist, y_hist, with_matvec, accurate,
                                  shard=(n, start, edges))
    return fused_tail_local_plain(problem, x, d, alpha, g, s_hist, y_hist,
                                  with_matvec, n, start, edges, accurate)


def make_fused_tail(problem: str, vg_fallback, with_matvec: bool = True,
                    use_pallas: bool = True, accurate_dots: bool = False):
    """The fused post-line-search tail of a suite problem, with the
    reference's signature: ``tail(x, d, alpha, g, s_hist, y_hist) -> (x_new,
    f_new, g_new, s_row, y_row, sy, yy, gg, dgn, ggn, ygn, t1, t2)``, the
    two rows in the history's dtype and t1 / t2 = S y_new / Y y_new over the
    ring before this pair is stored (None without ``with_matvec``; the
    solver patches the slot's entries from the exact sums).

    For a problem with a kernel body under ``use_pallas=True`` a CUDA
    tensor launches the kernel (with the products at any history depth) or
    raises (another dtype than float32), and a CPU tensor takes the plain
    version; otherwise the tail is the plain composition around
    ``vg_fallback`` on any device, which is the reference's dispatch.
    ``alpha`` holds one value per lane (one element for one instance) on
    x's device; it is never read to the host.  A batch, (B, d) rows and a
    (B, m, d) ring, launches the kernel's batched form and returns every
    sum per lane, t1 and t2 as (B, m).

    ``accurate_dots`` compensates the seven sums (a Neumaier sum over the
    block partials in the kernel, ``compensated_dot`` in the plain
    version); the solver reads the returned callable's ``accurate_dots``
    attribute and rejects a plain tail under ``cfg.accurate_dots``."""
    has_kernel = use_pallas and problem in BODY_IDS

    def tail(x, d, alpha, g, s_hist=None, y_hist=None):
        if has_kernel and x.device.type != "cpu":
            return _fused_tail_kernel(problem, x, d, alpha, g, s_hist,
                                      y_hist, with_matvec, accurate_dots)
        return fused_tail_plain(vg_fallback, x, d, alpha, g, s_hist, y_hist,
                                with_matvec, accurate_dots)

    tail.accurate_dots = accurate_dots
    return tail


#: bench.py's tail: chained Rosenbrock, no matvec, plain sums.
fused_tail_rosenbrock = make_fused_tail("rosenbrock", rosenbrock_vg_plain,
                                        with_matvec=False)


# --- iteration tail of any objective ----------------------------------------

def iteration_tail_plain(x: Tensor, d: Tensor, alpha: Tensor, g: Tensor,
                         g_new: Tensor, accurate: bool = False):
    """(x_new, s, y, s.y, y.y, g_new.g_new, d.g_new, g.g_new) from plain
    tensor ops (the reference's jnp fallback of iteration_tail).  The sums
    accumulate in float64; ``accurate`` takes them through
    ``utils.accurate.compensated_dot`` instead, all five in one call.
    Batched, ``alpha`` holds one step per lane."""
    s = per_lane(alpha) * d
    y = g_new - g
    if accurate:
        sums = compensated_dot(torch.stack([s, y, g_new, d, g]),
                               torch.stack([y, y, g_new, g_new, g_new]))
        return (x + s, s, y, *sums.unbind(0))
    return (x + s, s, y, _dot(s, y), _dot(y, y), _dot(g_new, g_new),
            _dot(d, g_new), _dot(g, g_new))


def iteration_tail(x: Tensor, d: Tensor, alpha: Tensor, g: Tensor,
                   g_new: Tensor, use_pallas: bool = True,
                   accurate: bool = False):
    """(x_new, s, y, s.y, y.y, g_new.g_new, d.g_new, g.g_new) in one pass
    over x, d, g and g_new, with the reference's signature and return
    tuple.  ``use_pallas=True`` launches the CUDA kernel for CUDA tensors
    (float32 or float64, a (d,) vector or (B, d) rows with one alpha and
    five sums per lane) and takes the plain version for CPU tensors; False
    is the plain version anywhere.  ``accurate`` compensates the
    cross-block accumulation of the five sums (a Neumaier sum over the
    block partials in the kernel, ``compensated_dot`` in the plain
    version).  ``alpha`` holds one value per lane (one element for one
    instance) on x's device; it is never read to the host."""
    if not use_pallas or x.device.type == "cpu":
        return iteration_tail_plain(x, d, alpha, g, g_new, accurate)
    suffix = _kernel_dtype("x", x)
    for name, t in (("x", x), ("d", d), ("g", g), ("g_new", g_new)):
        _check_vec(name, t, x.shape, x.dtype, x)
    lanes, n = _lanes(x), x.shape[-1]
    _check_per_lane("alpha", alpha, lanes, x)
    lib = _build.load()
    x_new, s_row, y_row = (torch.empty_like(x) for _ in range(3))
    # Five partials per block, and in float64 compensated form five
    # compensations beside them.
    partials = torch.empty(10 * (lib.tl_max_blocks() + (lanes or 0)),
                           dtype=torch.float64, device=x.device)
    sums = torch.empty((5,) if lanes is None else (5, lanes), dtype=x.dtype,
                       device=x.device)
    ptrs = (x.data_ptr(), d.data_ptr(), g.data_ptr(), g_new.data_ptr(),
            alpha.data_ptr(), x_new.data_ptr(), s_row.data_ptr(),
            y_row.data_ptr(), partials.data_ptr(), sums.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lanes is None:
            name = "iteration_tail"
            err = getattr(lib, f"tl_iteration_tail_{suffix}")(
                *ptrs, n, int(accurate), stream)
        else:
            name = "iteration_tail_batched"
            err = getattr(lib, f"tl_iteration_tail_batched_{suffix}")(
                *ptrs, lanes, n, int(accurate), stream)
    _build.check(lib, err, name)
    counts.count(launches, name)
    return (x_new, s_row, y_row, *sums.unbind(0))


def compensated_sum_plain(partials, comps=None) -> float:
    """The compensated stage 2 of the kernels' sums
    (``csrc/reduce.cuh::finish_sums_compensated``), operation for operation
    in float64, for the tests: lane l of 32 runs the Neumaier recurrence
    over ``partials[l::32]`` in order, adding ``comps[b]`` (a compensation
    per partial, where stage 1 kept one) to its compensation after partial
    b; the 32 (sum, compensation) pairs then fold by the kernel's shuffle
    tree, lane i taking lane i + 16, then i + 8, 4, 2, 1, the sums by
    TwoSum and the compensations by plain addition; the result is sum +
    compensation, unrounded."""
    lanes = 32
    sums, cmps = [0.0] * lanes, [0.0] * lanes
    for b, p in enumerate(map(float, partials)):
        lane, s = b % lanes, sums[b % lanes]
        t = s + p
        cmps[lane] += (s - t) + p if abs(s) >= abs(p) else (p - t) + s
        sums[lane] = t
        if comps is not None:
            cmps[lane] += float(comps[b])
    off = lanes // 2
    while off:
        for i in range(off):
            a, b = sums[i], sums[i + off]
            s = a + b
            bb = s - a
            e = (a - (s - bb)) + (b - bb)
            sums[i], cmps[i] = s, (cmps[i] + cmps[i + off]) + e
        off //= 2
    return sums[0] + cmps[0]


# --- the compact direction's combine ----------------------------------------

def combine_direction_plain(g: Tensor, s_hist: Tensor, y_hist: Tensor,
                            v: Tensor, u: Tensor, gamma: Tensor) -> Tensor:
    """r = gamma g + v S - gamma u Y accumulated row by row in the working
    dtype, ``acc = (acc + v_k s_k) - (gamma u_k) y_k`` for k ascending: the
    order of the reference's Pallas kernel and of the CUDA kernel, which
    therefore equals this bit for bit.  A ring in another dtype (bfloat16)
    is widened to g's as it is read, the coefficients stay as they are.
    One instance ((m, d) history, (m,) v and u, one gamma) or a batch
    ((B, m, d), (B, m), (B,)), each lane in the same order, so a lane's row
    equals the one-instance call on it bit for bit."""
    lane = per_lane if g.dim() > 1 else (lambda t: t)
    acc = lane(gamma) * g
    for k in range(s_hist.shape[-2]):
        s_k, y_k = s_hist[..., k, :], y_hist[..., k, :]
        if s_k.dtype != g.dtype:
            s_k, y_k = s_k.to(g.dtype), y_k.to(g.dtype)
        acc = acc + lane(v[..., k]) * s_k - lane(gamma * u[..., k]) * y_k
    return acc


def combine_direction_matmul(g: Tensor, s_hist: Tensor, y_hist: Tensor,
                             v: Tensor, u: Tensor, gamma: Tensor) -> Tensor:
    """r = gamma g + v S - gamma u Y as two matrix-vector products over the
    (m, d) ring, or per lane over a (B, m, d) ring (the reference's
    _combine_jnp, which its solver pins; the port's solver takes this
    route too).  For a ring in another dtype than g's (bfloat16) the
    coefficient vectors are cast down to the ring's dtype, as the
    reference casts them, and the products are formed and added in g's
    dtype: the ring is widened, since a bfloat16 matmul would round its
    result to bfloat16."""
    if s_hist.dtype != g.dtype:
        v, u = (c.to(s_hist.dtype).to(g.dtype) for c in (v, u))
        s_hist, y_hist = s_hist.to(g.dtype), y_hist.to(g.dtype)
    if s_hist.dim() == 2:
        return gamma * g + torch.mv(s_hist.T, v) - gamma * torch.mv(
            y_hist.T, u)

    def rows(coef, hist):
        return torch.bmm(coef.unsqueeze(1), hist).squeeze(1)

    gamma = gamma.unsqueeze(-1)
    return gamma * g + rows(v, s_hist) - gamma * rows(u, y_hist)


def combine_direction(g: Tensor, s_hist: Tensor, y_hist: Tensor, v: Tensor,
                      u: Tensor, gamma: Tensor,
                      use_pallas: bool = True) -> Tensor:
    """The compact representation's second pass over the history, with the
    reference's signature.  ``use_pallas=True`` launches the CUDA kernel
    for CUDA tensors (float32 or float64, one instance or a batch of (B, d)
    rows with a (B, m, d) ring, (B, m) v and u and (B,) gamma, the history
    in the iterate's dtype or bfloat16 under float32) and takes its plain
    version for CPU tensors; False is the matrix-vector route anywhere.
    ``v``, ``u`` and ``gamma`` stay on the device."""
    if not use_pallas:
        return combine_direction_matmul(g, s_hist, y_hist, v, u, gamma)
    if g.device.type == "cpu":
        return combine_direction_plain(g, s_hist, y_hist, v, u, gamma)
    suffix = _kernel_dtype("g", g)
    _check_vec("g", g, g.shape, g.dtype)
    lanes, n, m = _lanes(g), g.shape[-1], s_hist.shape[-2]
    if s_hist.dtype == torch.bfloat16 and g.dtype == torch.float32:
        suffix = "f32_bf16"
    elif s_hist.dtype != g.dtype:
        raise TypeError(
            f"s_hist: the combine_direction kernel takes a {g.dtype} "
            "history, or a bfloat16 one for float32 iterates, got "
            f"{s_hist.dtype}")
    ring = g.shape[:-1] + (m, n)
    for name, t in (("s_hist", s_hist), ("y_hist", y_hist)):
        if (t.device != g.device or t.dtype != s_hist.dtype
                or t.shape != ring or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous {tuple(ring)} "
                             f"{s_hist.dtype} tensor on {g.device}, got "
                             f"{t.dtype} shape {tuple(t.shape)}, strides "
                             f"{t.stride()} on {t.device}")
    for name, t in (("v", v), ("u", u)):
        _check_vec(name, t, g.shape[:-1] + (m,), g.dtype, g)
    _check_per_lane("gamma", gamma, lanes, g)
    lib = _build.load()
    r = torch.empty_like(g)
    ptrs = (g.data_ptr(), s_hist.data_ptr(), y_hist.data_ptr(), v.data_ptr(),
            u.data_ptr(), gamma.data_ptr(), r.data_ptr(), m)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        if lanes is None:
            name = "combine_direction"
            err = getattr(lib, f"tl_combine_direction_{suffix}")(
                *ptrs, n, stream)
        else:
            name = "combine_direction_batched"
            err = getattr(lib, f"tl_combine_direction_batched_{suffix}")(
                *ptrs, lanes, n, stream)
    _build.check(lib, err, name)
    counts.count(launches, name)
    return r
