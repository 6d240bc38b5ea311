"""The compact direction's small-matrix head for one instance, in plain
PyTorch: ``tpu_lbfgs.kernels.chain.chain_jnp``.

It is O(m^2) work on (m, m) matrices, so it is not a kernel port.  (The
reference's fused Pallas kernel of this chain, ``_make_chain_kernel``, runs
only for vmapped batches and is still to be ported.)  The logical-order
rotation uses index gathers where the reference used one-hot permutation
matmuls, which only paid on the TPU.
"""
from __future__ import annotations

import torch
from torch import Tensor


def chain_torch(SY_p: Tensor, YY_p: Tensor, Sg_p: Tensor, Yg_p: Tensor,
                sy_hist: Tensor, yy_hist: Tensor, n_pairs: Tensor,
                g_norm: Tensor, m: int, skip_thr):
    """(v_phys, u_phys, gamma, g_dot_d, fallback_pre) for one instance, as
    ``chain_jnp``: rotate the products to logical order, build the masked
    R, solve R u = p1 and R^T v = D u + gamma YY u - gamma p2, scatter v and
    u back to slot order, and flag invalid curvature."""
    from ..core.direction import _ring_logical_slots

    dtype, dev = SY_p.dtype, SY_p.device
    slots, valid = _ring_logical_slots(n_pairs, m)
    idx = slots.long()
    SY = SY_p.index_select(0, idx).index_select(1, idx)
    YY = YY_p.index_select(0, idx).index_select(1, idx)
    diag = torch.diagonal(SY)
    if skip_thr is not None:
        valid = valid & (diag > skip_thr)
    p1 = torch.where(valid, Sg_p.index_select(0, idx), 0.0)
    p2 = torch.where(valid, Yg_p.index_select(0, idx), 0.0)

    vmask2 = valid[:, None] & valid[None, :]
    d_diag = torch.where(valid, diag, 1.0)
    eye = torch.eye(m, dtype=dtype, device=dev)
    R = torch.where(vmask2, torch.triu(SY), 0.0) + (~valid).to(dtype) * eye
    YYm = torch.where(vmask2, YY, 0.0)

    newest = ((n_pairs - 1) % m).long().reshape(1)
    gamma = sy_hist.index_select(0, newest)[0] \
        / yy_hist.index_select(0, newest)[0]

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
    fallback = bad_rho | bad_gamma | (hist_len == 0) | ~small_ok

    gg = g_norm * g_norm
    g_dot_d = -(gamma * gg + torch.dot(v, p1) - gamma * torch.dot(u, p2))
    return v_phys, u_phys, gamma, g_dot_d, fallback
