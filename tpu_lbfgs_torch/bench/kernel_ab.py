"""Compare the four fused kernel families between two source trees on one
card: registers, outputs and times of the whole-vector entries.

    python3 -m tpu_lbfgs_torch.bench.kernel_ab PARENT_CSRC [CHANGE_CSRC]

``PARENT_CSRC`` is a directory with another commit's ``csrc`` sources (from
``git archive <commit> tpu_lbfgs_torch/csrc``, unpacked into a directory
that .gitignore lists); ``CHANGE_CSRC`` defaults to this tree's.  Both are
built with the flags of ``kernels/_build.py`` into their own libraries, and
the C entries ``tl_fused_vg_f32``, ``tl_fused_tail_f32``,
``tl_multi_phi_f32`` and ``tl_multi_phi_dphi_f32`` are called through
``ctypes`` in turns in one process (parent, change, change, parent), so both
see the same card, clocks and inputs.  For each kernel it prints

- the registers per thread the compiler reports for each instantiation that
  both trees have (a template can change a kernel's registers, and so its
  blocks per SM, with its instructions unchanged),
- whether the two trees' outputs are equal bit for bit (every vector, every
  sum), and
- the median device time of each (CUDA events around ten calls queued
  behind a sleep kernel, microseconds) and their ratio.

It needs a CUDA device and nvcc and exits non-zero without them, or when an
output differs.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from ..kernels import _build

N = 1 << 20
BODIES = ("quadratic", "rosenbrock", "coupled_quadratic")
_SIGS = {k: _build._SIGNATURES[k]
         for k in ("tl_max_blocks", "tl_fused_vg_f32", "tl_fused_tail_f32",
                   "tl_multi_phi_f32", "tl_multi_phi_dphi_f32")}


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
    out = {}
    for name, r in zip(plain, regs):
        if re.search(r", (true|\(bool\)1)>", name):
            continue        # a shard-local form: the parent has none
        # One key for both trees: drop what the shard-local template added.
        key = re.sub(r", (false|\(bool\)0)>", ">", name)
        out[key.replace(", tl::Shard)", ")")] = int(r)
    return out


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


def _calls(lib, body: int):
    """{kernel: (callable, output tensors)} of the whole-vector entries on
    fixed inputs, for one body."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(body)
    x, d, g = (torch.empty(N, device=dev).uniform_(-2, 2, generator=gen)
               for _ in range(3))
    m = 10
    S, Y = (torch.empty(m, N, device=dev).uniform_(-1, 1, generator=gen)
            for _ in range(2))
    alpha = torch.full((1,), 0.37, device=dev)
    nb = lib.tl_max_blocks()
    stream = torch.cuda.current_stream().cuda_stream
    out = {}

    g_out, f_out = torch.empty(N, device=dev), torch.empty(1, device=dev)
    part = torch.empty(nb, dtype=torch.float64, device=dev)
    out["fused_vg"] = (lambda: lib.tl_fused_vg_f32(
        body, x.data_ptr(), g_out.data_ptr(), part.data_ptr(),
        f_out.data_ptr(), N, stream), (g_out, f_out))

    for mm in (0, m):
        vecs = [torch.empty(N, device=dev) for _ in range(4)]
        sums = torch.empty(7 + 2 * mm, device=dev)
        tpart = torch.empty((7 + 2 * mm) * nb, dtype=torch.float64,
                            device=dev)
        out[f"fused_tail m={mm}"] = (
            lambda mm=mm, vecs=vecs, sums=sums, tpart=tpart:
            lib.tl_fused_tail_f32(
                body, 0, mm, 0, x.data_ptr(), d.data_ptr(), g.data_ptr(),
                alpha.data_ptr(), S.data_ptr(), Y.data_ptr(),
                *(v.data_ptr() for v in vecs), tpart.data_ptr(),
                sums.data_ptr(), N, stream), (*vecs, sums))

    for kernel, outputs in (("multi_phi", 1), ("multi_phi_dphi", 2)):
        for k in (8, 36):
            alphas = torch.linspace(1e-3, 1.0, k, device=dev)
            res = torch.empty(outputs * k, device=dev)
            kpart = torch.empty(outputs * k * nb, dtype=torch.float64,
                                device=dev)
            fn = getattr(lib, f"tl_{kernel}_f32")
            out[f"{kernel} K={k}"] = (
                lambda fn=fn, alphas=alphas, res=res, kpart=kpart, k=k:
                fn(body, x.data_ptr(), d.data_ptr(), alphas.data_ptr(), k,
                   kpart.data_ptr(), res.data_ptr(), N, stream), (res,))
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("kernel_ab needs a CUDA device", file=sys.stderr)
        return 1
    parent_dir = Path(argv[0]).resolve()
    change_dir = Path(argv[1]).resolve() if len(argv) > 1 else _build.CSRC
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    parent, ps, preport = _load(parent_dir)
    change, cs, creport = _load(change_dir)
    print(f"built parent in {ps:.1f} s, change in {cs:.1f} s")

    pregs, cregs = _registers(preport), _registers(creport)
    moved = {k: (pregs[k], cregs[k]) for k in pregs
             if k in cregs and pregs[k] != cregs[k]}
    print(f"registers: {len(set(pregs) & set(cregs))} kernels in both trees, "
          f"{len(moved)} with another count")
    for k, (a, b) in sorted(moved.items()):
        print(f"  {k}: parent {a}, change {b}")

    bad = 0
    for body, name in enumerate(BODIES):
        pcalls, ccalls = _calls(parent, body), _calls(change, body)
        for kernel in pcalls:
            (pf, pouts), (cf, couts) = pcalls[kernel], ccalls[kernel]
            if pf() or cf():
                print(f"{name} {kernel}: a launch failed")
                bad += 1
                continue
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(pouts, couts))
            bad += not same
            t = [_time(f) for f in (pf, cf, cf, pf)]
            tp, tc = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
            print(f"{name} {kernel}: outputs "
                  f"{'bit-equal' if same else 'DIFFER'}; parent {tp:.2f} us "
                  f"({t[0]:.2f}, {t[3]:.2f}), change {tc:.2f} us "
                  f"({t[1]:.2f}, {t[2]:.2f}), change/parent {tc / tp:.3f} "
                  f"on {card}")
    print(f"kernel_ab: {'ok' if not bad else f'{bad} kernels differ'}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
