"""The compact direction's small-matrix head (``tpu_lbfgs.kernels.chain``).

  chain_torch            one instance, in plain PyTorch, as the reference's
                         ``chain_jnp``.  O(m^2) work on (m, m) matrices: the
                         single-instance solve runs it, as the reference
                         does, and it is no kernel port.
  compact_chain_batched  B instances at once: the CUDA kernel
                         (csrc/compact_chain.cu; replaces the Pallas
                         ``_make_chain_kernel``, which the reference's
                         ``custom_vmap`` rule runs for vmapped float32
                         batches), in float32 and float64, m = 1 to MAX_M.
  chain_batched_plain    its plain PyTorch version, in the Pallas kernel's
                         order of operations.

The logical-order rotation uses index gathers where the reference used
one-hot permutation matmuls or select chains, which only paid on the TPU.
A gather gives the select chains' NaN semantics exactly; the one-hot
matmuls, the reference's default, spread a non-finite product to every
entry, which ``onehot_spread`` reproduces where the reference runs them
(``reference_spreads``).  Its one-hot sums of the newest sy_hist and
yy_hist compile to selects and spread nothing, as the gather.

As in ``fused_ops``, the batched wrapper takes its plain version only for
tensors on the CPU, and ``launches`` counts its kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import _build

#: Kernel launches since the last ``reset_launches()``.
launches = {"compact_chain": 0}

#: The deepest history the CUDA kernel takes (csrc/compact_chain.cu kMaxM).
MAX_M = 64
#: The kernel's entry point and threshold type for each dtype.
_ENTRY = {torch.float32: ("tl_compact_chain_f32", ctypes.c_float),
          torch.float64: ("tl_compact_chain_f64", ctypes.c_double)}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def reference_spreads(SY_p: Tensor) -> bool:
    """Whether the reference's chain spreads non-finite products for these
    (B, m, m) ones: its vmapped one-hot chain does
    (tpu_lbfgs/kernels/chain.py:67-80, :99-104), its Pallas chain, taken
    for float32 batches of B % 1024 == 0 (:313-325), selects and does
    not."""
    return not (SY_p.dtype == torch.float32 and SY_p.shape[0] % 1024 == 0)


def onehot_spread(SY_p: Tensor, YY_p: Tensor, Sg_p: Tensor, Yg_p: Tensor,
                  diag: Tensor):
    """(diagonal, damaged): what the reference's one-hot reorderings make
    of non-finite products, for one instance or a batch.

    ``P @ A @ P.T`` (and ``P @ v``) adds every entry of A into every entry
    of the result, with weight 1 or 0, and 0 * inf and 0 * NaN are NaN
    (XLA keeps these dots as dots, compiled or not).  So an entry of the
    result keeps its value when every non-finite entry of A is that entry
    itself, and is NaN otherwise.  Of SY that decides the
    diagonal, which the pair skip reads: returned as the reference sees it.
    Every other entry (R, YY, p1, p2) enters the chain only through valid
    pairs, and there a non-finite one makes u or v non-finite and the chain
    falls back to -g: ``damaged`` is whether SY, YY, Sg or Yg holds a
    non-finite entry, which falls back where any pair is valid."""
    # x - x is NaN exactly where x is not finite, else 0: few operations
    # and no scalar, which the host-bound single-instance iteration pays
    # for.  An entry keeps its value iff SY's count of non-finite entries
    # equals its own (0 or 1).
    mm = SY_p.shape[-1] * SY_p.shape[-2]
    every = torch.cat([SY_p.flatten(-2), YY_p.flatten(-2), Sg_p, Yg_p],
                      dim=-1)
    zeros = every - every
    damaged = torch.isnan(zeros.sum(-1))
    n_bad = torch.isnan(zeros[..., :mm]).sum(-1, keepdim=True)
    zero_d = diag - diag
    keep = torch.isnan(zero_d) == n_bad
    return torch.where(keep, diag, zero_d / zero_d), damaged


def chain_torch(SY_p: Tensor, YY_p: Tensor, Sg_p: Tensor, Yg_p: Tensor,
                sy_hist: Tensor, yy_hist: Tensor, n_pairs: Tensor,
                g_norm: Tensor, m: int, skip_thr):
    """(v_phys, u_phys, gamma, g_dot_d, fallback_pre) for one instance, as
    ``chain_jnp``: rotate the products to logical order, build the masked
    R, solve R u = p1 and R^T v = D u + gamma YY u - gamma p2, scatter v and
    u back to slot order, and flag invalid curvature, non-finite entries
    spread as the reference's one-hot products spread them
    (``onehot_spread``)."""
    from ..core.direction import _newest_ratio, _ring_logical_slots

    dtype, dev = SY_p.dtype, SY_p.device
    slots, valid = _ring_logical_slots(n_pairs, m)
    idx = slots.long()
    SY = SY_p.index_select(0, idx).index_select(1, idx)
    YY = YY_p.index_select(0, idx).index_select(1, idx)
    diag, damaged = onehot_spread(SY_p, YY_p, Sg_p, Yg_p, torch.diagonal(SY))
    if skip_thr is not None:
        valid = valid & (diag > skip_thr)
    p1 = torch.where(valid, Sg_p.index_select(0, idx), 0.0)
    p2 = torch.where(valid, Yg_p.index_select(0, idx), 0.0)

    vmask2 = valid[:, None] & valid[None, :]
    d_diag = torch.where(valid, diag, 1.0)
    eye = torch.eye(m, dtype=dtype, device=dev)
    R = torch.where(vmask2, torch.triu(SY), 0.0) + (~valid).to(dtype) * eye
    YYm = torch.where(vmask2, YY, 0.0)

    gamma = _newest_ratio(sy_hist, yy_hist, n_pairs, m)

    u = torch.linalg.solve_triangular(R, p1[:, None], upper=True)[:, 0]
    t = d_diag * u + gamma * (YYm @ u) - gamma * p2
    v = torch.linalg.solve_triangular(R.T, t[:, None], upper=False)[:, 0]

    zero = torch.zeros(m, dtype=dtype, device=dev)
    v_phys = zero.index_copy(0, idx, torch.where(valid, v, 0.0))
    u_phys = zero.index_copy(0, idx, torch.where(valid, u, 0.0))

    bad_gamma = (gamma <= 0) | ~torch.isfinite(gamma)
    bad_rho = torch.any(valid & ~torch.isfinite(
        1.0 / torch.where(valid, diag, 1.0)))
    small_ok = torch.all(torch.isfinite(v_phys)) & torch.all(
        torch.isfinite(u_phys))
    hist_len = torch.clamp(n_pairs, max=m)
    fallback = (bad_rho | bad_gamma | (hist_len == 0) | ~small_ok
                | (damaged & valid.any()))

    gg = g_norm * g_norm
    g_dot_d = -(gamma * gg + torch.dot(v, p1) - gamma * torch.dot(u, p2))
    return v_phys, u_phys, gamma, g_dot_d, fallback


def chain_batched_plain(SY_p: Tensor, YY_p: Tensor, Sg_p: Tensor,
                        Yg_p: Tensor, sy_hist: Tensor, yy_hist: Tensor,
                        n_pairs: Tensor, g_norm: Tensor, m: int, skip_thr):
    """``chain_torch`` for B instances at once: (B, m, m), (B, m) and (B,)
    in, (v_phys, u_phys, gamma, g_dot_d, fallback) out, non-finite
    products spread as by ``onehot_spread`` where ``reference_spreads``.

    It follows the Pallas kernel (tpu_lbfgs/kernels/chain.py:122-233)
    operation for operation, so that the CUDA kernel, built with
    -fmad=false, equals it bit for bit: both substitutions as loops in the
    kernel's order, the YY u sum and the v.p1 / u.p2 sums in index order.
    Each loop step is one op over all lanes; the forward substitution
    updates every later row per step, which subtracts in the same order."""
    from ..core.direction import _newest_ratio, _ring_logical_slots

    B = SY_p.shape[0]
    slots, valid = _ring_logical_slots(n_pairs, m)            # (B, m)
    idx = slots.long()
    rows = idx[:, :, None].expand(B, m, m)
    cols = idx[:, None, :].expand(B, m, m)
    SY = SY_p.gather(1, rows).gather(2, cols)               # logical order
    YY = YY_p.gather(1, rows).gather(2, cols)
    diag = torch.diagonal(SY, dim1=1, dim2=2)
    spread = reference_spreads(SY_p)
    if spread:
        diag, damaged = onehot_spread(SY_p, YY_p, Sg_p, Yg_p, diag)
    if skip_thr is not None:
        valid = valid & (diag > skip_thr)
    zero = torch.zeros((), dtype=SY_p.dtype, device=SY_p.device)
    p1 = torch.where(valid, Sg_p.gather(1, idx), zero)
    p2 = torch.where(valid, Yg_p.gather(1, idx), zero)
    d_diag = torch.where(valid, diag, 1.0)                   # = R's diagonal
    vmask2 = valid[:, :, None] & valid[:, None, :]
    R = torch.where(vmask2, SY, zero)                        # read above diag
    YYm = torch.where(vmask2, YY, zero)
    gamma = _newest_ratio(sy_hist, yy_hist, n_pairs, m)

    # back substitution, R u = p1: row i subtracts j = i+1 .. m-1 in order
    u = [None] * m
    for i in range(m - 1, -1, -1):
        acc = p1[:, i]
        for k in range(i + 1, m):
            acc = acc - R[:, i, k] * u[k]
        u[i] = acc / d_diag[:, i]
    u = torch.stack(u, dim=1)
    # t = D u + gamma (YYm u) - gamma p2, the sum over q in index order
    acc = torch.zeros_like(u)
    for q in range(m):
        acc = acc + YYm[:, :, q] * u[:, q, None]
    g1 = gamma[:, None]
    t = d_diag * u + g1 * acc - g1 * p2
    # forward substitution, R^T v = t: row i subtracts j = 0 .. i-1 in order
    v = []
    for i in range(m):
        v.append(t[:, i] / d_diag[:, i])
        t[:, i + 1:] -= R[:, i, i + 1:] * v[i][:, None]
    v = torch.stack(v, dim=1)

    vz = torch.where(valid, v, zero)
    uz = torch.where(valid, u, zero)
    v_phys = torch.zeros_like(vz).scatter(1, idx, vz)
    u_phys = torch.zeros_like(uz).scatter(1, idx, uz)
    small_ok = (torch.isfinite(v_phys) & torch.isfinite(u_phys)).all(dim=1)
    bad_gamma = (gamma <= 0) | ~torch.isfinite(gamma)
    bad_rho = (valid & ~torch.isfinite(1.0 / d_diag)).any(dim=1)
    fallback = bad_rho | bad_gamma | (n_pairs == 0) | ~small_ok
    if spread:
        fallback = fallback | (damaged & valid.any(dim=1))

    gg = g_norm * g_norm
    vp1, up2 = v * p1, u * p2
    vdp1, udp2 = vp1[:, 0], up2[:, 0]
    for l in range(1, m):
        vdp1 = vdp1 + vp1[:, l]
        udp2 = udp2 + up2[:, l]
    g_dot_d = -(gamma * gg + vdp1 - gamma * udp2)
    return v_phys, u_phys, gamma, g_dot_d, fallback


def check_chain_args(args, m: int) -> None:
    """Raise unless the CUDA kernel takes these eight tensors (SY_p .. g_norm)
    at history depth m: float32 or float64, 1 <= m <= MAX_M, contiguous
    (B, m, m), (B, m) and (B,) shapes on one device, n_pairs int32."""
    if args[0].dtype not in _ENTRY:
        raise TypeError(f"compact_chain: the CUDA kernel takes float32 or "
                        f"float64, got {args[0].dtype}")
    if not 1 <= m <= MAX_M:
        raise ValueError(
            f"compact_chain: the CUDA kernel takes m from 1 to {MAX_M}, not "
            f"m={m} (a deeper history is ROADMAP Queue 2 item 5)")
    B, dt = args[0].shape[0], args[0].dtype
    shapes = [(B, m, m)] * 2 + [(B, m)] * 4 + [(B,)] * 2
    dtypes = [dt] * 6 + [torch.int32, dt]
    names = ("SY_p", "YY_p", "Sg_p", "Yg_p", "sy_hist", "yy_hist", "n_pairs",
             "g_norm")
    for name, t, shape, dtype in zip(names, args, shapes, dtypes):
        if t.device != args[0].device:
            raise ValueError(f"compact_chain: {name} is on {t.device}, "
                             f"SY_p on {args[0].device}")
        if tuple(t.shape) != shape or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(
                f"compact_chain: {name} must be a contiguous {shape} "
                f"{dtype} tensor, got {tuple(t.shape)} {t.dtype}")


def compact_chain_batched(SY_p: Tensor, YY_p: Tensor, Sg_p: Tensor,
                          Yg_p: Tensor, sy_hist: Tensor, yy_hist: Tensor,
                          n_pairs: Tensor, g_norm: Tensor, m: int, skip_thr):
    """The batched chain: the CUDA kernel for CUDA float32 and float64
    tensors, at any B and m from 1 to MAX_M; the plain version for CPU
    tensors.  Anything else raises (``check_chain_args``)."""
    args = (SY_p, YY_p, Sg_p, Yg_p, sy_hist, yy_hist, n_pairs, g_norm)
    dev = SY_p.device
    if dev.type == "cpu":
        return chain_batched_plain(*args, m=m, skip_thr=skip_thr)
    if dev.type != "cuda":
        raise ValueError(f"compact_chain: expected a CUDA tensor, got {dev}")
    check_chain_args(args, m)
    B, dt = SY_p.shape[0], SY_p.dtype
    entry, c_scalar = _ENTRY[dt]
    lib = _build.load()
    v_phys = torch.empty((B, m), dtype=dt, device=dev)
    u_phys = torch.empty_like(v_phys)
    gamma = torch.empty(B, dtype=dt, device=dev)
    g_dot_d = torch.empty_like(gamma)
    fallback = torch.empty(B, dtype=torch.bool, device=dev)
    use_thr = skip_thr is not None
    with torch.cuda.device(dev):
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in args),
            c_scalar(skip_thr if use_thr else 0.0), int(use_thr),
            int(reference_spreads(SY_p)), v_phys.data_ptr(),
            u_phys.data_ptr(), gamma.data_ptr(), g_dot_d.data_ptr(),
            fallback.data_ptr(), B, m,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "compact_chain")
    launches["compact_chain"] += 1
    return v_phys, u_phys, gamma, g_dot_d, fallback
