"""Hand-written CUDA kernels of the solver's main path, each beside its
plain PyTorch version.

  fused_vg_rosenbrock     f and the analytic gradient in one read of x
                          (csrc/rosenbrock_vg.cu; replaces the Pallas
                          _vg_rosenbrock_kernel).
  fused_tail_rosenbrock   the post-line-search tail in one pass over x, d, g
                          (csrc/rosenbrock_fused_tail.cu; replaces the Pallas
                          _make_tail_kernel with _body_rosenbrock).

Both a kernel and its plain version form each sum from the same float32
terms, accumulate in float64 and round once to the working dtype, so the
two differ only by the order of float64 additions.

A wrapper takes its plain version only for tensors on the CPU, where the
tests run.  A CUDA tensor launches the kernel (float32 only), and anything
else raises.  ``launches`` counts each wrapper's kernel launches, so a run
can show that it went through the kernels.
"""
from __future__ import annotations

import torch
from torch import Tensor

from . import _build

#: Kernel launches per wrapper since the last ``reset_launches()``.
launches = {"rosenbrock_vg": 0, "rosenbrock_fused_tail": 0}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _check_vec(name: str, t: Tensor, n: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(
            f"{name}: the CUDA kernel takes float32, got {t.dtype}")
    if t.dim() != 1 or t.numel() != n or not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous ({n},) vector, got "
                         f"shape {tuple(t.shape)}, strides {t.stride()}")


def _sum(t: Tensor) -> Tensor:
    return torch.sum(t, dtype=torch.float64).to(t.dtype)


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return torch.dot(a.double(), b.double()).to(a.dtype)


# --- value and gradient -----------------------------------------------------

def rosenbrock_vg_plain(x: Tensor) -> tuple[Tensor, Tensor]:
    """Chained Rosenbrock f and gradient from plain tensor ops (the
    reference's jnp fallback of fused_vg_rosenbrock)."""
    xi, xn = x[:-1], x[1:]
    t1 = xn - xi * xi
    t2 = 1.0 - xi
    f = _sum(100.0 * t1 * t1 + t2 * t2)
    g = torch.zeros_like(x)
    g[:-1] += 2.0 * (xi - 1.0) - 400.0 * xi * t1
    g[1:] += 200.0 * t1
    return f, g


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
    g.g_new, y.g_new, None, None); the history is not read."""
    s = alpha * d
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
