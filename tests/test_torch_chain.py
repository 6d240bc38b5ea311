"""The port's batched compact chain (tpu_lbfgs_torch.kernels.chain) against
the JAX package, on the CPU.

On the CPU ``compact_chain_batched`` runs its plain version,
``chain_batched_plain``; the JAX package's fused chain runs as its Pallas
kernel in interpret mode (``jax.vmap`` of ``make_compact_chain`` at a batch
of 1024 lanes, float32).  The CUDA kernel is held to the plain version bit
for bit by chip_smoke.py on the card.  Inputs come from numpy.
"""
import itertools
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lbfgs.kernels.chain import make_compact_chain
from tpu_lbfgs_torch.kernels import chain
from tpu_lbfgs_torch.kernels.chain import (
    chain_batched_plain,
    chain_torch,
    compact_chain_batched,
)

# The tensors here are small: one intra-op thread is faster, and leaves
# the cores to the other test workers.
torch.set_num_threads(1)

B = 1024        # the JAX rule's smallest batch for its Pallas kernel
NAMES = ("v_phys", "u_phys", "gamma", "g_dot_d", "fallback")


def chain_inputs(rng, B, m, pathological=False):
    """Ring states as tests/test_chain.py draws them: empty, partial and
    wrapped histories, rejected pairs (below the skip threshold once
    pathological), and with pathological=True zero pivots, a negative
    newest s.y and NaN entries.  float64 numpy arrays, n_pairs int32."""
    SY = rng.uniform(0.1, 2.0, (B, m, m))
    # Diagonally dominant R: the comparison with a library solve is about
    # the chain, not about conditioning.
    SY[:, np.arange(m), np.arange(m)] += 2.0
    YY = rng.uniform(0.1, 2.0, (B, m, m))
    Sg = rng.uniform(-1, 1, (B, m))
    Yg = rng.uniform(-1, 1, (B, m))
    syh = rng.uniform(0.1, 2.0, (B, m))
    yyh = rng.uniform(0.1, 2.0, (B, m))
    n_pairs = rng.integers(0, 4 * m, (B,)).astype(np.int32)
    gn = rng.uniform(0.1, 10.0, (B,))
    if pathological:
        for i in range(0, B, 7):
            SY[i, i % m, i % m] = 0.0
        for i in range(3, B, 11):
            syh[i] = -1.0
        for i in range(5, B, 13):
            SY[i, 0, 1] = np.nan
    return SY, YY, Sg, Yg, syh, yyh, n_pairs, gn


def _torch_args(arrays, dtype):
    return [torch.from_numpy(a).to(torch.int32 if a.dtype == np.int32
                                   else dtype) for a in arrays]


@lru_cache(maxsize=None)
def _jax_chain(m, skip_thr):
    return jax.jit(jax.vmap(make_compact_chain(m, skip_thr)))


@pytest.mark.parametrize("pathological", [False, True])
@pytest.mark.parametrize("skip_thr", [None, 1e-10])
@pytest.mark.parametrize("m", [5, 7, 10])
def test_batched_plain_matches_pallas_chain(m, skip_thr, pathological):
    """float32 at B = 1024, where the JAX package runs its Pallas kernel.
    Equal fallback flags; the other outputs within the reference's own
    kernel-vs-jnp tolerance (tests/test_chain.py) on non-fallback lanes."""
    arrays = chain_inputs(np.random.default_rng(17 + m), B, m, pathological)
    want = _jax_chain(m, skip_thr)(*(
        jnp.asarray(a, jnp.int32 if a.dtype == np.int32 else jnp.float32)
        for a in arrays))
    got = chain_batched_plain(*_torch_args(arrays, torch.float32), m=m,
                              skip_thr=skip_thr)
    fb = np.asarray(want[4])
    np.testing.assert_array_equal(got[4].numpy(), fb)
    assert (~fb).sum() > B // 4, "too few lanes left to compare"
    if pathological:
        assert fb.sum() > B // 10, "the guard paths must be exercised"
    for name, a, b in zip(NAMES[:4], got, want):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy()[~fb], np.asarray(b)[~fb],
                                   rtol=2e-5, atol=2e-6, err_msg=name)


@pytest.mark.parametrize("skip_thr", [None, 1e-10])
def test_batched_plain_matches_chain_torch_per_lane(skip_thr):
    """float64, lane by lane against the single-instance chain (library
    triangular solves): equal fallback flags, the rest within 1e-11 on
    non-fallback lanes (substitution and the library solve round
    differently)."""
    m = 10
    arrays = chain_inputs(np.random.default_rng(3), 128, m, True)
    args = _torch_args(arrays, torch.float64)
    got = chain_batched_plain(*args, m=m, skip_thr=skip_thr)
    for b in range(128):
        want = chain_torch(*(a[b] for a in args), m=m, skip_thr=skip_thr)
        assert bool(got[4][b]) == bool(want[4]), b
        if want[4]:
            continue
        for name, a, w in zip(NAMES[:4], got, want):
            np.testing.assert_allclose(a[b].numpy(), w.numpy(), rtol=1e-11,
                                       atol=1e-12, err_msg=f"{name} {b}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_takes_the_plain_version_on_cpu(dtype):
    """A CPU batch runs the plain version, bit for bit, and launches no
    kernel; any B works (the reference's B % 1024 rule is a TPU tiling
    rule)."""
    m = 5
    args = _torch_args(chain_inputs(np.random.default_rng(4), 37, m, True),
                       dtype)
    chain.reset_launches()
    got = compact_chain_batched(*args, m=m, skip_thr=1e-10)
    want = chain_batched_plain(*args, m=m, skip_thr=1e-10)
    for name, a, w in zip(NAMES, got, want):
        assert torch.equal(a.nan_to_num(), w.nan_to_num()), name
    assert chain.launches == {"compact_chain": 0}


@pytest.mark.parametrize("m", [0, 1, 7, chain.MAX_M, chain.MAX_M + 1])
def test_kernel_argument_rule(m):
    """The CUDA kernel's argument rule, checked before any launch: m from 1
    to MAX_M, any B; outside that a ValueError that names the queue item
    of deeper histories; float32 or float64 only; shapes that match m."""
    args = _torch_args(chain_inputs(np.random.default_rng(6), 3, max(m, 1)),
                       torch.float32)
    if 1 <= m <= chain.MAX_M:
        chain.check_chain_args(args, m)
        chain.check_chain_args([a.double() if a.is_floating_point() else a
                                for a in args], m)
        with pytest.raises(ValueError, match="must be a contiguous"):
            chain.check_chain_args(args, m + 1 if m < chain.MAX_M else m - 1)
        with pytest.raises(TypeError, match="float32 or float64"):
            chain.check_chain_args([a.half() if a.is_floating_point() else a
                                    for a in args], m)
    else:
        with pytest.raises(ValueError, match="Queue 2 item 5"):
            chain.check_chain_args(args, m)


def test_wrapper_refuses_other_devices():
    m = 5
    args = [a.to("meta") for a in _torch_args(
        chain_inputs(np.random.default_rng(5), 8, m), torch.float32)]
    with pytest.raises(ValueError, match="CUDA"):
        compact_chain_batched(*args, m=m, skip_thr=None)


def _damaged_lanes(m):
    """float64 chain inputs, one lane per damage: each product and each
    scalar ring in turn holds a NaN, a +inf or a -inf, on a valid slot, an
    invalid one, the diagonal or off it, over full and partial rings."""
    rng = np.random.default_rng(23)
    lanes = []
    targets = [("SY", (0, 1)), ("SY", (1, 1)), ("SY", (m - 1, m - 1)),
               ("YY", (0, 0)), ("YY", (2, 1)), ("Sg", (1,)), ("Yg", (0,)),
               ("syh", (1,)), ("syh", (m - 1,)), ("yyh", (0,))]
    for (name, at), value, n_pairs in itertools.product(
            targets, (np.nan, np.inf, -np.inf), (m + 3, 2)):
        SY, YY, Sg, Yg, syh, yyh, _, gn = chain_inputs(rng, 1, m)
        arrays = dict(SY=SY[0], YY=YY[0], Sg=Sg[0], Yg=Yg[0], syh=syh[0],
                      yyh=yyh[0])
        arrays[name][at] = value
        lanes.append((arrays, n_pairs, gn[0]))
    # Two damaged entries, and an undamaged lane.
    SY, YY, Sg, Yg, syh, yyh, _, gn = chain_inputs(rng, 1, m)
    SY[0, 1, 1], SY[0, 2, 0] = np.inf, np.nan
    lanes.append((dict(SY=SY[0], YY=YY[0], Sg=Sg[0], Yg=Yg[0], syh=syh[0],
                       yyh=yyh[0]), m, gn[0]))
    SY, YY, Sg, Yg, syh, yyh, _, gn = chain_inputs(rng, 1, m)
    lanes.append((dict(SY=SY[0], YY=YY[0], Sg=Sg[0], Yg=Yg[0], syh=syh[0],
                       yyh=yyh[0]), m + 1, gn[0]))
    keys = ("SY", "YY", "Sg", "Yg", "syh", "yyh")
    out = [np.stack([lane[0][k] for lane in lanes]) for k in keys]
    out.append(np.array([lane[1] for lane in lanes], np.int32))
    out.append(np.array([lane[2] for lane in lanes]))
    return out


@pytest.mark.parametrize("skip_thr", [None, 1e-10])
def test_damaged_products_spread_as_the_reference(skip_thr):
    """Non-finite products and scalars, float64, where the reference runs
    its vmapped one-hot chain: the fallback flag of every lane equal to
    ``jax.vmap`` of the reference's chain, batched and lane by lane
    (``chain_torch``), and the other outputs on the lanes that do not fall
    back (those whose damage the pair skip or the newest pair masks)
    within 1e-11."""
    m = 5
    arrays = _damaged_lanes(m)
    want = _jax_chain(m, skip_thr)(*(
        jnp.asarray(a, jnp.int32 if a.dtype == np.int32 else jnp.float64)
        for a in arrays))
    args = _torch_args(arrays, torch.float64)
    got = chain_batched_plain(*args, m=m, skip_thr=skip_thr)
    fb = np.asarray(want[4])
    np.testing.assert_array_equal(got[4].numpy(), fb)
    assert fb.sum() >= 10 and (~fb).sum() >= 10
    for name, a, b in zip(NAMES[:4], got, want):
        np.testing.assert_allclose(a.numpy()[~fb], np.asarray(b)[~fb],
                                   rtol=1e-11, atol=1e-12, err_msg=name)
    for b in range(len(fb)):
        one = chain_torch(*(a[b] for a in args), m=m, skip_thr=skip_thr)
        assert bool(one[4]) == bool(fb[b]), b
