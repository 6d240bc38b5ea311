"""Compare the four fused kernel families between two source trees on one
card: registers, outputs and times of their C entries.

    python3 -m tpu_lbfgs_torch.bench.kernel_ab PARENT_CSRC [CHANGE_CSRC]
        [--only REGEX] [--sums-may-move REGEX]

``PARENT_CSRC`` is a directory with another commit's ``csrc`` sources (from
``git archive <commit> tpu_lbfgs_torch/csrc``, unpacked into a directory
that .gitignore lists); ``CHANGE_CSRC`` defaults to this tree's.  Both are
built with the flags of ``kernels/_build.py`` into their own libraries, and
the C entries are called through ``ctypes`` in turns in one process
(parent, change, change, parent), so both see the same card, clocks and
inputs, at d = 2^20 float32 (the shard-local entries on a block of 2^20 in
the middle of a d of 2^22):

- ``tl_fused_vg_f32`` and ``tl_fused_vg_local_f32``, and the first also on
  the second's block;
- ``tl_fused_tail_f32``: without products on a float32 ring, and with the
  history products t1, t2 at m = 5, 10 and 20 on a float32 and a bfloat16
  ring; ``tl_fused_tail_local_f32`` at m = 0 and m = 10; both with
  compensated sums (the Neumaier stage 2) at m = 0 and m = 10;
- ``tl_multi_phi_f32`` and ``tl_multi_phi_dphi_f32`` at K = 8 and 36, and
  their ``_local_f32`` forms at K = 8 and 36;
- the batched shard-local entries at sharded_vmap_minimize's shape, 4
  lanes of a block of 2^20 (``tl_fused_vg_local_batched_f32``,
  ``tl_fused_tail_local_batched_f32`` at m = 0 and 10,
  ``tl_multi_phi_local_batched_f32`` and
  ``tl_multi_phi_dphi_local_batched_f32`` at K = 8 and 36), each lane with
  its own edges, alphas and step, the two trees on the same buffers;

each for the three bodies; ``tl_iteration_tail_f32`` and
``tl_iteration_tail_f64``, plain and compensated;
``tl_combine_direction_f32``, ``_f64`` and ``_f32_bf16`` at m = 10; and
``tl_compact_chain_f32`` and ``tl_compact_chain_f64`` at B = 4096 and
m = 5, 10, 20 (both trees) and m = 7 (the change only, held to
``chain_batched_plain`` on the card: a tree older than the chain's runtime
m refuses it), on ring states with empty, partial and wrapped histories,
zero pivots and NaN entries.  A
chain's outputs are compared with NaN positions equal and the other values
bit for bit.  The batched entries (``tl_*_batched_*``, B = 4096 lanes of
d = 1024) run in the change only, as a tree without them has none: each
through its ``kernels.fused_ops`` wrapper on the change's library, held to
its batched plain version on the card (vectors bit for bit, the sums'
largest relative difference printed), and timed.  ``--only`` keeps the
calls whose label matches.
For each it prints

- the registers per thread the compiler reports for every instantiation of
  the two trees (a template can change a kernel's registers, and so its
  blocks per SM, with its instructions unchanged), and which moved,
- whether the two trees' outputs are equal bit for bit: the vectors, and
  the sums (a kernel that adds its sums in another order moves their last
  bits; for the labels ``--sums-may-move`` matches, the largest relative
  difference of a sum is printed instead), and
- the median device time of each (CUDA events around ten calls queued
  behind a sleep kernel, microseconds) and their ratio.

It needs a CUDA device and nvcc and exits non-zero without them, when a
launch fails, or when an output differs that may not.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels import _build, chain

N = 1 << 20
SHARDS = 4                  # the shard-local entries: block 1 of 4
BODIES = ("quadratic", "rosenbrock", "coupled_quadratic")
TAIL_M = (5, 10, 20)
CHAIN_B = 4096              # bench.py's batch
CHAIN_M = (5, 10, 20)       # both trees
CHAIN_M_CHANGE = (7,)       # the change only
BATCHED_D = 1024            # bench.py's batch cell, B = CHAIN_B
LOCAL_LANES = 4             # sharded_vmap_minimize's lanes of a block
BATCHED = ("tl_fused_vg_batched_f32", "tl_fused_tail_batched_f32",
           "tl_iteration_tail_batched_f32", "tl_iteration_tail_batched_f64",
           "tl_combine_direction_batched_f32",
           "tl_combine_direction_batched_f64",
           "tl_combine_direction_batched_f32_bf16")   # the change only
_SIGS = {k: _build._SIGNATURES[k]
         for k in ("tl_max_blocks", "tl_fused_vg_f32", "tl_fused_tail_f32",
                   "tl_multi_phi_f32", "tl_multi_phi_dphi_f32",
                   "tl_fused_vg_local_f32", "tl_fused_tail_local_f32",
                   "tl_multi_phi_local_f32", "tl_multi_phi_dphi_local_f32",
                   "tl_compact_chain_f32", "tl_compact_chain_f64",
                   "tl_iteration_tail_f32", "tl_iteration_tail_f64",
                   "tl_combine_direction_f32", "tl_combine_direction_f64",
                   "tl_combine_direction_f32_bf16",
                   "tl_fused_vg_local_batched_f32",
                   "tl_fused_tail_local_batched_f32",
                   "tl_multi_phi_local_batched_f32",
                   "tl_multi_phi_dphi_local_batched_f32")}


def _load(csrc: Path):
    path, seconds, report = _build.build(csrc)
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGS.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib, seconds, report


def _registers(report: str) -> dict:
    """{demangled kernel name: registers} from nvcc's -Xptxas -v report."""
    names = re.findall(r"Compiling entry function '(\S+)' for 'sm_90a'",
                       report)
    regs = re.findall(r"Used (\d+) registers", report)
    if not names:
        return {}
    plain = subprocess.run(["c++filt", *names], capture_output=True,
                           text=True, check=True).stdout.split("\n")
    return {name.replace("(bool)1", "true").replace("(bool)0", "false"):
            int(r) for name, r in zip(plain, regs)}


def _time(fn, calls=10, reps=5):
    """Median device time of one call, microseconds: the card first spins
    on a sleep kernel while the host queues ``calls`` calls, so the events
    time back-to-back device work and not the host's launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(100_000_000)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) * 1e3 / calls)
    return statistics.median(times)


def _calls(lib, body: int, shared: dict):
    """{label: (callable, output vectors, output sums)} of the C entries on
    fixed inputs, for one body; the batched shard-local entries on the
    tensors ``shared``, which both trees are given."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(body)
    uniform = lambda *shape: torch.empty(*shape, device=dev).uniform_(
        -2, 2, generator=gen)
    xw, dw, gw = (uniform(SHARDS * N) for _ in range(3))
    x, d, g = (t[:N] for t in (xw, dw, gw))
    xl, dl, gl = (t[N:2 * N] for t in (xw, dw, gw))
    edges = torch.stack([xw[N - 1], dw[N - 1], xw[2 * N], dw[2 * N]])
    mmax = max(TAIL_M)
    rings = {"f32": [uniform(mmax, N) / 2 for _ in range(2)]}
    rings["bf16"] = [r.to(torch.bfloat16) for r in rings["f32"]]
    alpha = torch.full((1,), 0.37, device=dev)
    nb = lib.tl_max_blocks()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    # The whole-vector kernel also on the shard-local entry's block, for the
    # local form's cost against it.
    for sfx, local, xx in (("", False, x), (" local", True, xl),
                           (" on the local block", False, xl)):
        g_out = torch.empty(N, device=dev)
        f_out = torch.empty(1, device=dev,
                            dtype=torch.float64 if local else torch.float32)
        part = torch.empty(nb, dtype=torch.float64, device=dev)
        e_vg = edges[[0, 2]].contiguous()   # kept alive by the closure
        tail_args = (SHARDS * N, N, e_vg.data_ptr()) if local else ()
        entry = lib.tl_fused_vg_local_f32 if local else lib.tl_fused_vg_f32
        out[f"fused_vg{sfx}"] = (
            lambda entry=entry, xx=xx, g_out=g_out, part=part, f_out=f_out,
            tail_args=tail_args, e_vg=e_vg: entry(
                body, xx.data_ptr(), g_out.data_ptr(), part.data_ptr(),
                f_out.data_ptr(), N, *tail_args, stream), (g_out,), (f_out,))

    tails = [("f32", 0, False)] + [(h, m, False) for h in ("f32", "bf16")
                                   for m in TAIL_M]
    tails += [("f32", 0, True), ("f32", 10, True)]
    tails = [(h, m, local, 0) for h, m, local in tails]
    tails += [("f32", m, local, 1) for local in (False, True)
              for m in (0, 10)]
    for h, m, local, comp in tails:
        S, Y = (r[:m].contiguous() if m else r for r in rings[h])
        hdt = S.dtype
        vecs = [torch.empty(N, device=dev) for _ in range(2)]
        vecs += [torch.empty(N, device=dev, dtype=hdt) for _ in range(2)]
        sums = torch.empty(7 + 2 * m, device=dev,
                           dtype=torch.float64 if local else torch.float32)
        tpart = torch.empty((7 + 2 * m) * nb, dtype=torch.float64, device=dev)
        xx, dd, gg = (xl, dl, gl) if local else (x, d, g)
        extra = (SHARDS * N, N, edges.data_ptr()) if local else ()
        entry = (lib.tl_fused_tail_local_f32 if local
                 else lib.tl_fused_tail_f32)
        label = (f"fused_tail{' local' if local else ''} ring {h} m={m}"
                 + (" compensated" if comp else ""))
        out[label] = (
            lambda entry=entry, h=h, m=m, S=S, Y=Y, vecs=vecs, sums=sums,
            tpart=tpart, xx=xx, dd=dd, gg=gg, extra=extra, comp=comp: entry(
                body, int(h == "bf16"), m, comp, xx.data_ptr(),
                dd.data_ptr(), gg.data_ptr(), alpha.data_ptr(),
                S.data_ptr(), Y.data_ptr(),
                *(v.data_ptr() for v in vecs), tpart.data_ptr(),
                sums.data_ptr(), N, *extra, stream), tuple(vecs), (sums,))

    for kernel, outputs in (("multi_phi", 1), ("multi_phi_dphi", 2)):
        for k, local in ((8, False), (36, False), (8, True), (36, True)):
            alphas = torch.linspace(1e-3, 1.0, k, device=dev)
            res = torch.empty(outputs * k, device=dev,
                              dtype=torch.float64 if local else torch.float32)
            kpart = torch.empty(outputs * k * nb, dtype=torch.float64,
                                device=dev)
            xx, dd = (xl, dl) if local else (x, d)
            e = (edges[2:] if kernel == "multi_phi" else edges).contiguous()
            extra = (SHARDS * N, N, e.data_ptr()) if local else ()
            fn = getattr(lib, f"tl_{kernel}{'_local' if local else ''}_f32")
            out[f"{kernel}{' local' if local else ''} K={k}"] = (
                lambda fn=fn, alphas=alphas, res=res, kpart=kpart, k=k,
                xx=xx, dd=dd, extra=extra, e=e:
                fn(body, xx.data_ptr(), dd.data_ptr(), alphas.data_ptr(), k,
                   kpart.data_ptr(), res.data_ptr(), N, *extra, stream),
                (), (res,))
    out.update(_local_batched_calls(lib, body, stream, shared))
    return out


def _local_batched_tensors(body: int, nb: int) -> dict:
    """The inputs and outputs of the batched shard-local entries for one
    body, made once and handed to both trees, so that a time compares the
    kernels and not where their buffers lie (with a set each, the same
    library read up to 10% apart on fused_vg)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(100 + body)
    uniform = lambda *shape: torch.empty(*shape, device=dev).uniform_(
        -2, 2, generator=gen)
    B = LOCAL_LANES
    t = {"x": uniform(B, N), "d": uniform(B, N), "g": uniform(B, N),
         "edges": uniform(B, 4)}
    t["e_vg"] = t["edges"][:, [0, 2]].contiguous()
    t["e_phi"] = t["edges"][:, 2:].contiguous()
    t["f_out"] = torch.empty(B, dtype=torch.float64, device=dev)
    t["g_out"] = torch.empty(B, N, device=dev)
    t["part"] = torch.empty(B + nb, dtype=torch.float64, device=dev)
    t["alpha"] = 0.25 + uniform(B).abs() / 8
    for m in (0, 10):
        t["ring", m] = [uniform(B, max(m, 1), N) / 2 for _ in range(2)]
        t["vecs", m] = [torch.empty(B, N, device=dev) for _ in range(4)]
        t["sums", m] = torch.empty((7 + 2 * m) * B, dtype=torch.float64,
                                   device=dev)
        t["tpart", m] = torch.empty((7 + 2 * m) * (B + nb),
                                    dtype=torch.float64, device=dev)
    for k in (8, 36):
        t["alphas", k] = (torch.linspace(1e-3, 1.0, k, device=dev)
                          * (1.0 + torch.arange(B, device=dev)[:, None] / 8)
                          ).contiguous()
    for kernel, outputs in (("multi_phi", 1), ("multi_phi_dphi", 2)):
        for k in (8, 36):
            t["res", kernel, k] = torch.empty(outputs * k * B,
                                              dtype=torch.float64, device=dev)
            t["kpart", kernel, k] = torch.empty(outputs * k * (nb + B),
                                                dtype=torch.float64,
                                                device=dev)
    return t


def _local_batched_calls(lib, body: int, stream, t: dict):
    """{label: (callable, output vectors, output sums)} of the batched
    shard-local entries (tl_*_local_batched_f32) at sharded_vmap_minimize's
    shape: LOCAL_LANES lanes of block 1 of 4 of a d of 2^22, each lane with
    its own edges, alphas and steps, on the tensors ``t``
    (_local_batched_tensors)."""
    B = LOCAL_LANES
    where = (SHARDS * N, N)
    x, d, g, alpha = t["x"], t["d"], t["g"], t["alpha"]
    out = {}
    out[f"fused_vg local batched B={B}"] = (
        lambda: lib.tl_fused_vg_local_batched_f32(
            body, x.data_ptr(), t["g_out"].data_ptr(), t["part"].data_ptr(),
            t["f_out"].data_ptr(), B, N, *where, t["e_vg"].data_ptr(),
            stream),
        (t["g_out"],), (t["f_out"],))
    for m in (0, 10):
        S, Y = t["ring", m]
        vecs, sums, tpart = t["vecs", m], t["sums", m], t["tpart", m]
        out[f"fused_tail local batched B={B} ring f32 m={m}"] = (
            lambda m=m, S=S, Y=Y, vecs=vecs, sums=sums, tpart=tpart:
            lib.tl_fused_tail_local_batched_f32(
                body, 0, m, 0, x.data_ptr(), d.data_ptr(), g.data_ptr(),
                alpha.data_ptr(), S.data_ptr(), Y.data_ptr(),
                *(v.data_ptr() for v in vecs), tpart.data_ptr(),
                sums.data_ptr(), B, N, *where, t["edges"].data_ptr(),
                stream),
            tuple(vecs), (sums,))
    for kernel in ("multi_phi", "multi_phi_dphi"):
        e = t["e_phi"] if kernel == "multi_phi" else t["edges"]
        fn = getattr(lib, f"tl_{kernel}_local_batched_f32")
        for k in (8, 36):
            alphas, res = t["alphas", k], t["res", kernel, k]
            kpart = t["kpart", kernel, k]
            out[f"{kernel} local batched B={B} K={k}"] = (
                lambda fn=fn, alphas=alphas, res=res, kpart=kpart, k=k, e=e:
                fn(body, x.data_ptr(), d.data_ptr(), alphas.data_ptr(), k,
                   kpart.data_ptr(), res.data_ptr(), B, N, *where,
                   e.data_ptr(), stream),
                (), (res,))
    return out


def _general_calls(lib):
    """{label: (callable, output vectors, output sums)} of
    tl_iteration_tail_f32 / _f64, plain and compensated, on fixed inputs
    (g_new near 1, so the sum of its squares loses bits in a float32 running
    sum), and of tl_combine_direction_f32 / _f64 / _f32_bf16 at m = 10."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    stream = torch.cuda.current_stream().cuda_stream
    nb = lib.tl_max_blocks()
    out = {}
    for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        x, d, g = (torch.empty(N, device=dev, dtype=dt).uniform_(
            -2, 2, generator=gen) for _ in range(3))
        g_new = 1.0 + 1e-3 * torch.empty(N, device=dev, dtype=dt).uniform_(
            -1, 1, generator=gen)
        alpha = torch.full((1,), 0.37, device=dev, dtype=dt)
        fn = getattr(lib, f"tl_iteration_tail_{name}")
        for comp in (0, 1):
            vecs = [torch.empty(N, device=dev, dtype=dt) for _ in range(3)]
            sums = torch.empty(5, device=dev, dtype=dt)
            part = torch.empty(10 * nb, dtype=torch.float64, device=dev)
            label = (f"iteration_tail {name} "
                     f"{'compensated' if comp else 'plain'}")
            out[label] = (
                lambda fn=fn, ins=(x, d, g, g_new, alpha), vecs=vecs,
                part=part, sums=sums, comp=comp: fn(
                    *(t.data_ptr() for t in ins),
                    *(v.data_ptr() for v in vecs), part.data_ptr(),
                    sums.data_ptr(), N, comp, stream), tuple(vecs), (sums,))
    m = 10
    for dt, hdt, name in ((torch.float32, torch.float32, "f32"),
                          (torch.float64, torch.float64, "f64"),
                          (torch.float32, torch.bfloat16, "f32_bf16")):
        g = torch.empty(N, device=dev, dtype=dt).uniform_(-2, 2,
                                                          generator=gen)
        ring = [torch.empty(m, N, device=dev, dtype=dt).uniform_(
            -2, 2, generator=gen).to(hdt) for _ in range(2)]
        v, u = (torch.empty(m, device=dev, dtype=dt).uniform_(
            -1, 1, generator=gen) for _ in range(2))
        gamma = torch.full((1,), 0.37, device=dev, dtype=dt)
        r = torch.empty(N, device=dev, dtype=dt)
        fn = getattr(lib, f"tl_combine_direction_{name}")
        out[f"combine_direction {name} m={m}"] = (
            lambda fn=fn, ins=(g, *ring, v, u, gamma), r=r: fn(
                *(t.data_ptr() for t in ins), r.data_ptr(), m, N, stream),
            (r,), ())
    return out


def _chain_args(m: int, dt):
    """Batched ring states for the chain (those of chip_smoke.py's chain
    phase): the eight input tensors on the card."""
    rng = np.random.default_rng(m)
    B = CHAIN_B
    SY = rng.uniform(0.1, 2.0, (B, m, m))
    SY[:, np.arange(m), np.arange(m)] += 2.0
    YY = rng.uniform(0.1, 2.0, (B, m, m))
    vecs = [rng.uniform(-1, 1, (B, m)) for _ in range(2)]
    vecs += [rng.uniform(0.1, 2.0, (B, m)) for _ in range(2)]
    vecs[2][3::11] = -1.0                                 # bad gamma
    n_pairs = rng.integers(0, 4 * m, (B,))
    gn = rng.uniform(0.1, 10.0, (B,))
    SY[::7, 0, 0] = 0.0                                   # zero pivots
    SY[5::13, 0, min(1, m - 1)] = np.nan                  # NaN entries
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev, dt) for a in (SY, YY, *vecs)]
    return args + [torch.from_numpy(n_pairs).to(dev, torch.int32),
                   torch.from_numpy(gn).to(dev, dt)]


def _chain_call(lib, m: int, dt, args):
    """(callable, outputs) of tl_compact_chain_<dt> with the skip
    threshold 1e-10 (bench.py's batch)."""
    entry, c_scalar = chain._ENTRY[dt]
    dev = args[0].device
    outs = [torch.empty((CHAIN_B, m), dtype=dt, device=dev) for _ in range(2)]
    outs += [torch.empty(CHAIN_B, dtype=dt, device=dev) for _ in range(2)]
    outs.append(torch.empty(CHAIN_B, dtype=torch.bool, device=dev))
    fn = getattr(lib, entry)
    stream = torch.cuda.current_stream().cuda_stream
    spread = int(chain.reference_spreads(args[0]))
    return (lambda: fn(*(t.data_ptr() for t in args), c_scalar(1e-10), 1,
                       spread, *(o.data_ptr() for o in outs), CHAIN_B, m,
                       stream),
            outs)


def _same_nan(a, b):
    """NaN at the same places and every other value bit-equal."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and _same(a[~nan], b[~nan])


def _chain_ab(parent, change, card, only) -> int:
    """Both trees' chains in turns at CHAIN_M; the change's alone, against
    the plain version, at CHAIN_M_CHANGE.  Returns the count of chains
    whose outputs differ."""
    bad = 0
    for m, dt in itertools.product(CHAIN_M + CHAIN_M_CHANGE,
                                   (torch.float32, torch.float64)):
        name = "f32" if dt == torch.float32 else "f64"
        label = f"compact_chain {name} m={m} B={CHAIN_B}"
        if only and not re.search(only, label):
            continue
        args = _chain_args(m, dt)
        cf, cout = _chain_call(change, m, dt, args)
        if m in CHAIN_M_CHANGE:
            err = cf()
            ref = chain.chain_batched_plain(*args, m=m, skip_thr=1e-10)
            torch.cuda.synchronize()
            same = not err and all(map(_same_nan, cout, ref))
            bad += not same
            tc = statistics.median(_time(cf) for _ in range(2))
            print(f"{label}: change only (the parent refuses m={m}): launch "
                  f"{err}, outputs {'equal' if same else 'DIFFER'} to the "
                  f"plain version on the card; change {tc:.2f} us on {card}")
            continue
        pf, pout = _chain_call(parent, m, dt, args)
        errs = (pf(), cf())
        if any(errs):
            print(f"{label}: a launch failed {errs}")
            bad += 1
            continue
        torch.cuda.synchronize()
        same = all(map(_same_nan, cout, pout))
        bad += not same
        t = [_time(f) for f in (pf, cf, cf, pf)]
        tp, tc = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"{label}: outputs {'bit-equal' if same else 'DIFFER'}; parent "
              f"{tp:.2f} us ({t[0]:.2f}, {t[3]:.2f}), change {tc:.2f} us "
              f"({t[1]:.2f}, {t[2]:.2f}), change/parent {tc / tp:.3f} on "
              f"{card}")
    return bad


def _pick(out, order):
    """out's entries in ``order``, those that are None left out."""
    return tuple(out[i] for i in order if out[i] is not None)


def _batched_calls():
    """{label: (kernel call, plain call, number of leading vectors)} of the
    batched wrappers at B = CHAIN_B, d = BATCHED_D on fixed inputs; each
    call returns the wrapper's tuple (vectors first, then sums)."""
    from ..kernels import fused_ops as ops

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    shape = (CHAIN_B, BATCHED_D)
    uniform = lambda *sh, dt=torch.float32: torch.empty(
        *sh, device=dev, dtype=dt).uniform_(-1, 1, generator=gen)
    out = {}
    for dt, name in ((torch.float32, "f32"), (torch.float64, "f64")):
        x, d, g, gn = (uniform(*shape, dt=dt) for _ in range(4))
        alpha = 0.25 + uniform(CHAIN_B, dt=dt).abs()
        for acc in (False, True):
            args = (x, d, alpha, g, gn, acc)
            out[f"iteration_tail {name} "
                f"{'compensated' if acc else 'plain'}"] = (
                lambda args=args: ops.iteration_tail(*args[:5],
                                                     accurate=args[5]),
                lambda args=args: ops.iteration_tail_plain(*args), 3)
        for hd, ring in ((dt, name), (torch.bfloat16, "bf16")):
            if hd == torch.bfloat16 and dt == torch.float64:
                continue
            S, Y = (uniform(CHAIN_B, 10, BATCHED_D).to(hd) for _ in range(2))
            v, u = (uniform(CHAIN_B, 10, dt=dt) for _ in range(2))
            gamma = 0.5 + uniform(CHAIN_B, dt=dt).abs()
            cargs = (g, S, Y, v, u, gamma)
            out[f"combine_direction {name} ring {ring} m=10"] = (
                lambda a=cargs: (ops.combine_direction(*a),),
                lambda a=cargs: (ops.combine_direction_plain(*a),), 1)
    x, d, g = (2.0 * uniform(*shape) for _ in range(3))
    alpha = 0.25 + uniform(CHAIN_B).abs()
    for body in BODIES:
        plain = ops.VG_PLAIN[body]
        out[f"{body} fused_vg"] = (
            lambda b=body: ops.fused_vg(b, x)[::-1],
            lambda p=plain: p(x)[::-1], 1)
        for m, hd, acc in ((0, torch.float32, False), (0, torch.float32, True),
                           (10, torch.float32, False),
                           (10, torch.bfloat16, False)):
            S, Y = (uniform(CHAIN_B, max(m, 1), BATCHED_D).to(hd)
                    for _ in range(2))
            tail = ops.make_fused_tail(body, plain, with_matvec=m > 0,
                                       accurate_dots=acc)
            targs = (x, d, alpha, g, S, Y)
            label = (f"{body} fused_tail m={m} ring "
                     f"{'bf16' if hd == torch.bfloat16 else 'f32'}"
                     + (" compensated" if acc else ""))
            # (x_new, g_new, s_row, y_row, then the sums and t1, t2)
            order = (0, 2, 3, 4, 1, 5, 6, 7, 8, 9, 10, 11, 12)
            out[label] = (
                lambda t=tail, a=targs: _pick(t(*a), order),
                lambda p=plain, a=targs, mv=m > 0, c=acc: _pick(
                    ops.fused_tail_plain(p, *a, mv, c), order), 4)
    return out


def _batched_ab(change, card, only) -> int:
    """The batched entries, the change only: each wrapper on the change's
    library against its batched plain version.  Returns the count whose
    vectors differ or whose launch fails."""
    for name in BATCHED:
        fn = getattr(change, name)
        fn.argtypes, fn.restype = _build._SIGNATURES[name]
    real = _build.load
    _build.load = lambda: change
    bad = 0
    try:
        for label, (kernel, plain, n_vec) in _batched_calls().items():
            label = f"batched {label} B={CHAIN_B} d={BATCHED_D}"
            if only and not re.search(only, label):
                continue
            try:
                got = kernel()
            except RuntimeError as e:
                print(f"{label}: a launch failed ({e})")
                bad += 1
                continue
            want = plain()
            torch.cuda.synchronize()
            same = all(_same(a, b) for a, b in zip(got[:n_vec], want[:n_vec]))
            bad += not same
            rel = max((_sum_rel(a, b) for a, b in zip(got[n_vec:],
                                                      want[n_vec:])),
                      default=0.0)
            tc = statistics.median(_time(kernel) for _ in range(2))
            print(f"{label}: change only, vectors "
                  f"{'bit-equal' if same else 'DIFFER'} to the plain "
                  f"version, sums within {rel:.2e} relative; change "
                  f"{tc:.2f} us on {card}")
    finally:
        _build.load = real
    return bad


def _same(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _sum_rel(a, b):
    """Largest |a - b| / |b| over the sums (0 where both are 0)."""
    a, b = a.double(), b.double()
    return ((a - b).abs() / b.abs().clamp(min=1e-300)).max().item()


def _ab_call(label, pcall, ccall, moving, card) -> bool:
    """One label of both trees in turns: prints whether their outputs are
    equal and their times; True where an output differs that may not."""
    (pf, pvec, psum), (cf, cvec, csum) = pcall, ccall
    err = pf()
    torch.cuda.synchronize()
    # The parent's outputs, kept: the trees may share their buffers.
    pvec, psum = ([v.clone() for v in vs] for vs in (pvec, psum))
    errs = (err, cf())
    if any(errs):
        print(f"{label}: a launch failed {errs}")
        return True
    torch.cuda.synchronize()
    vec_same = all(_same(a, b) for a, b in zip(pvec, cvec))
    sum_same = all(_same(a, b) for a, b in zip(psum, csum))
    sums = ("sums bit-equal" if sum_same else
            f"sums differ by {max(map(_sum_rel, csum, psum)):.2e} "
            "relative" + ("" if moving else " (MAY NOT)"))
    # Timed after the comparison: the calls overwrite shared buffers.
    t = [_time(f) for f in (pf, cf, cf, pf)]
    tp, tc = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"{label}: vectors {'bit-equal' if vec_same else 'DIFFER'}, "
          f"{sums}; parent {tp:.2f} us ({t[0]:.2f}, {t[3]:.2f}), change "
          f"{tc:.2f} us ({t[1]:.2f}, {t[2]:.2f}), change/parent "
          f"{tc / tp:.3f} on {card}")
    return not vec_same or (not sum_same and not moving)


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="kernel_ab")
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?")
    ap.add_argument("--only", default="")
    ap.add_argument("--sums-may-move", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA device", file=sys.stderr)
        return 1
    parent_dir = Path(args.parent).resolve()
    change_dir = Path(args.change).resolve() if args.change else _build.CSRC
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    print(f"parent {parent_dir}, change {change_dir}")
    parent, ps, preport = _load(parent_dir)
    change, cs, creport = _load(change_dir)
    print(f"built parent in {ps:.1f} s, change in {cs:.1f} s")

    pregs, cregs = _registers(preport), _registers(creport)
    both = sorted(set(pregs) & set(cregs))
    moved = [k for k in both if pregs[k] != cregs[k]]
    print(f"registers: {len(both)} kernels in both trees, {len(moved)} with "
          f"another count")
    for k in moved:
        print(f"  moved {k}: parent {pregs[k]}, change {cregs[k]}")
    for k in sorted(set(pregs) ^ set(cregs)):
        tree = "parent" if k in pregs else "change"
        print(f"  only in {tree}: {k}: {pregs.get(k, cregs.get(k))}")
    for k in both:
        if re.search(args.only or ".", k) and (
                "tail" in k or "phi" in k or "chain" in k or "vg" in k
                or "finish" in k or args.only):
            print(f"  {k}: parent {pregs[k]}, change {cregs[k]}")

    may_move = re.compile(args.sums_may_move) if args.sums_may_move else None
    bad = 0
    nb = max(parent.tl_max_blocks(), change.tl_max_blocks())
    groups = []
    for body, name in enumerate(BODIES):
        shared = _local_batched_tensors(body, nb)
        groups.append((name, _calls(parent, body, shared),
                       _calls(change, body, shared)))
    groups.append(("general", _general_calls(parent), _general_calls(change)))
    for name, pcalls, ccalls in groups:
        for label in pcalls:
            if args.only and not re.search(args.only, label):
                continue
            moving = may_move is not None and bool(may_move.search(label))
            bad += _ab_call(f"{name} {label}", pcalls[label], ccalls[label],
                            moving, card)
    bad += _chain_ab(parent, change, card, args.only)
    bad += _batched_ab(change, card, args.only)
    print(f"kernel_ab: {'ok' if not bad else f'{bad} kernels differ'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
