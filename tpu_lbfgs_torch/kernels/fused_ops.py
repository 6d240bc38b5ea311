"""Hand-written CUDA kernels of the solver's iteration, each beside its
plain PyTorch version.

  fused_vg_rosenbrock     f and the analytic gradient in one read of x
                          (csrc/rosenbrock_vg.cu; replaces the Pallas
                          _vg_rosenbrock_kernel).
  fused_tail_rosenbrock   the post-line-search tail in one pass over x, d, g
                          (csrc/rosenbrock_fused_tail.cu; replaces the Pallas
                          _make_tail_kernel with _body_rosenbrock).
  iteration_tail          the tail of any objective, given its new gradient:
                          x_new, s, y and five sums in one pass
                          (csrc/iteration_tail.cu; replaces the Pallas
                          _make_iteration_tail_kernel, plain and compensated).
  combine_direction       r = gamma g + v S - gamma u Y in one stream over
                          the history (csrc/combine_direction.cu; replaces
                          the Pallas _combine_kernel).

A kernel and its plain version form each sum from the same terms in the
working dtype, accumulate in float64 and round once to the working dtype,
so the two differ only by the order of float64 additions.

The plain versions take an optional leading batch axis, ``(..., d)`` with
every sum over the last axis, for the batch solve (which, like the
reference's, runs them and never the kernels).  The kernels take one
contiguous ``(d,)`` vector.

A wrapper takes its plain version only for tensors on the CPU, where the
tests run (or where the caller passes ``use_pallas=False``, the
reference's switch).  A CUDA tensor launches the kernel (the Rosenbrock
kernels float32 only, the two general ones float32 or float64), and
anything else raises.  ``launches`` counts each wrapper's kernel launches,
so a run can show that it went through the kernels.
"""
from __future__ import annotations

import torch
from torch import Tensor

from ..types import per_lane
from ..utils.accurate import compensated_dot
from . import _build

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {"rosenbrock_vg": 0, "rosenbrock_fused_tail": 0,
            "iteration_tail": 0, "combine_direction": 0}

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_vec(name: str, t: Tensor, n: int, dtype=torch.float32,
               like: Tensor = None) -> None:
    if t.device.type != "cuda" or (like is not None
                                   and t.device != like.device):
        raise ValueError(f"{name}: expected a CUDA tensor"
                         + (f" on {like.device}" if like is not None else "")
                         + f", got {t.device}")
    if t.dtype != dtype:
        raise TypeError(
            f"{name}: the CUDA kernel takes {dtype} here, got {t.dtype}")
    if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n},) vector, got "
                         f"shape {tuple(t.shape)}, strides {t.stride()}")


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


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """a . b over the last axis, accumulated in float64."""
    return _vdot(a.double(), b.double()).to(a.dtype)


# --- value and gradient -----------------------------------------------------

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


def fused_vg_rosenbrock(x: Tensor) -> tuple[Tensor, Tensor]:
    """(f, g) of chained Rosenbrock: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return rosenbrock_vg_plain(x)
    n = x.numel()
    _check_vec("x", x, n)
    lib = _build.load()
    g = torch.empty_like(x)
    partials = torch.empty(lib.tl_max_blocks(), dtype=torch.float64,
                           device=x.device)
    f = torch.empty(1, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tl_rosenbrock_vg_f32(
            x.data_ptr(), g.data_ptr(), partials.data_ptr(), f.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "rosenbrock_vg")
    launches["rosenbrock_vg"] += 1
    return f[0], g


# --- fused iteration tail ---------------------------------------------------

def fused_tail_plain(vg_fn, x: Tensor, d: Tensor, alpha: Tensor, g: Tensor,
                     s_hist=None, y_hist=None):
    """The tail from plain tensor ops and any value-and-gradient function
    (the reference's fused_tail_jnp with with_matvec=False).  Returns
    (x_new, f_new, g_new, s_row, y_row, s.y, y.y, g_new.g_new, d.g_new,
    g.g_new, y.g_new, None, None); the history is not read.  Batched,
    ``alpha`` holds one step per lane."""
    s = per_lane(alpha) * d
    x_new = x + s
    f_new, g_new = vg_fn(x_new)
    y = g_new - g
    return (x_new, f_new, g_new, s, y,
            _dot(s, y), _dot(y, y), _dot(g_new, g_new),
            _dot(d, g_new), _dot(g, g_new), _dot(y, g_new),
            None, None)


def fused_tail_rosenbrock(x: Tensor, d: Tensor, alpha: Tensor, g: Tensor,
                          s_hist=None, y_hist=None):
    """The post-line-search tail of chained Rosenbrock, with the return
    tuple of the reference's make_fused_tail (t1 = t2 = None): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  ``alpha``
    is a one-element tensor on x's device; it is never read to the host."""
    if x.device.type == "cpu":
        return fused_tail_plain(rosenbrock_vg_plain, x, d, alpha, g)
    n = x.numel()
    for name, t in (("x", x), ("d", d), ("g", g)):
        _check_vec(name, t, n)
    if (alpha.device != x.device or alpha.dtype != torch.float32
            or alpha.numel() != 1):
        raise ValueError("alpha: expected one float32 element on "
                         f"{x.device}, got {alpha.dtype} {tuple(alpha.shape)} "
                         f"on {alpha.device}")
    if s_hist is not None and s_hist.dtype != torch.float32:
        raise NotImplementedError(
            f"{s_hist.dtype} history is not ported (ROADMAP.md Queue 1 "
            "item 8)")
    lib = _build.load()
    x_new, g_new, s_row, y_row = (torch.empty_like(x) for _ in range(4))
    partials = torch.empty(7 * lib.tl_max_blocks(), dtype=torch.float64,
                           device=x.device)
    sums = torch.empty(7, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.tl_rosenbrock_fused_tail_f32(
            x.data_ptr(), d.data_ptr(), g.data_ptr(), alpha.data_ptr(),
            x_new.data_ptr(), g_new.data_ptr(), s_row.data_ptr(),
            y_row.data_ptr(), partials.data_ptr(), sums.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "rosenbrock_fused_tail")
    launches["rosenbrock_fused_tail"] += 1
    f_new, sy, yy, gg, dgn, ggn, ygn = sums.unbind(0)
    return (x_new, f_new, g_new, s_row, y_row, sy, yy, gg, dgn, ggn, ygn,
            None, None)


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
    (float32 or float64, one instance) and takes the plain version for CPU
    tensors; False is the plain version anywhere.  ``accurate``
    compensates the cross-block accumulation of the five sums (a Neumaier
    sum over the block partials in the kernel, ``compensated_dot`` in the
    plain version).  ``alpha`` is a one-element tensor on x's device; it is
    never read to the host."""
    if not use_pallas or x.device.type == "cpu":
        return iteration_tail_plain(x, d, alpha, g, g_new, accurate)
    if x.dim() != 1:
        raise NotImplementedError(
            "the iteration_tail kernel takes one instance; a batched form "
            "is not ported to tpu_lbfgs_torch yet (ROADMAP.md Queue 2 item "
            "1); pass use_pallas=False for the plain PyTorch version")
    suffix = _kernel_dtype("x", x)
    n = x.numel()
    for name, t in (("x", x), ("d", d), ("g", g), ("g_new", g_new)):
        _check_vec(name, t, n, x.dtype, x)
    if (alpha.device != x.device or alpha.dtype != x.dtype
            or alpha.numel() != 1):
        raise ValueError(f"alpha: expected one {x.dtype} element on "
                         f"{x.device}, got {alpha.dtype} "
                         f"{tuple(alpha.shape)} on {alpha.device}")
    lib = _build.load()
    x_new, s_row, y_row = (torch.empty_like(x) for _ in range(3))
    partials = torch.empty(5 * lib.tl_max_blocks(), dtype=torch.float64,
                           device=x.device)
    sums = torch.empty(5, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"tl_iteration_tail_{suffix}")(
            x.data_ptr(), d.data_ptr(), g.data_ptr(), g_new.data_ptr(),
            alpha.data_ptr(), x_new.data_ptr(), s_row.data_ptr(),
            y_row.data_ptr(), partials.data_ptr(), sums.data_ptr(), n,
            int(accurate), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "iteration_tail")
    launches["iteration_tail"] += 1
    return (x_new, s_row, y_row, *sums.unbind(0))


# --- the compact direction's combine ----------------------------------------

def combine_direction_plain(g: Tensor, s_hist: Tensor, y_hist: Tensor,
                            v: Tensor, u: Tensor, gamma: Tensor) -> Tensor:
    """r = gamma g + v S - gamma u Y accumulated row by row in the working
    dtype, ``acc = (acc + v_k s_k) - (gamma u_k) y_k`` for k ascending: the
    order of the reference's Pallas kernel and of the CUDA kernel, which
    therefore equals this bit for bit.  One instance, (m, d) history."""
    acc = gamma * g
    for k, (s_k, y_k) in enumerate(zip(s_hist.unbind(0), y_hist.unbind(0))):
        acc = acc + v[k] * s_k - (gamma * u[k]) * y_k
    return acc


def combine_direction_matmul(g: Tensor, s_hist: Tensor, y_hist: Tensor,
                             v: Tensor, u: Tensor, gamma: Tensor) -> Tensor:
    """r = gamma g + v S - gamma u Y as two matrix-vector products over the
    (m, d) ring, or per lane over a (B, m, d) ring (the reference's
    _combine_jnp, which its solver pins; the port's solver takes this
    route too)."""
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
    for CUDA tensors (float32 or float64, one instance, history in the
    iterate's dtype) and takes its plain version for CPU tensors; False is
    the matrix-vector route anywhere.  ``v``, ``u`` and ``gamma`` stay on
    the device."""
    if not use_pallas:
        return combine_direction_matmul(g, s_hist, y_hist, v, u, gamma)
    if g.dim() != 1 or s_hist.dim() != 2:
        raise NotImplementedError(
            "the combine_direction kernel takes one instance; a batched "
            "form is not ported to tpu_lbfgs_torch yet (ROADMAP.md Queue 2 "
            "item 3); pass use_pallas=False for the matrix-vector route")
    if g.device.type == "cpu":
        return combine_direction_plain(g, s_hist, y_hist, v, u, gamma)
    suffix = _kernel_dtype("g", g)
    n, m = g.numel(), s_hist.shape[0]
    _check_vec("g", g, n, g.dtype)
    for name, t in (("s_hist", s_hist), ("y_hist", y_hist)):
        if t.dtype != g.dtype:
            raise NotImplementedError(
                f"{name}: a {t.dtype} history for {g.dtype} iterates is not "
                "ported yet (ROADMAP.md Queue 1 item 8)")
        if (t.device != g.device or t.shape != (m, n)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous ({m}, {n}) "
                             f"tensor on {g.device}, got shape "
                             f"{tuple(t.shape)}, strides {t.stride()} on "
                             f"{t.device}")
    for name, t in (("v", v), ("u", u)):
        _check_vec(name, t, m, g.dtype, g)
    if (gamma.device != g.device or gamma.dtype != g.dtype
            or gamma.numel() != 1):
        raise ValueError(f"gamma: expected one {g.dtype} element on "
                         f"{g.device}, got {gamma.dtype} "
                         f"{tuple(gamma.shape)} on {gamma.device}")
    lib = _build.load()
    r = torch.empty_like(g)
    with torch.cuda.device(g.device):
        err = getattr(lib, f"tl_combine_direction_{suffix}")(
            g.data_ptr(), s_hist.data_ptr(), y_hist.data_ptr(), v.data_ptr(),
            u.data_ptr(), gamma.data_ptr(), r.data_ptr(), m, n,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "combine_direction")
    launches["combine_direction"] += 1
    return r
