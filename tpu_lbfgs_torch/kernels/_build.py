"""Build and load the port's CUDA kernels.

The sources under ``tpu_lbfgs_torch/csrc`` have a plain C interface.  At
first use each is compiled with ``nvcc`` for Hopper (``sm_90a``), all at
once in parallel, and the objects are linked into one shared library, which
is loaded with ``ctypes``.  The library lands in
``tpu_lbfgs_torch/_build/<hash>/``, keyed by a hash of the sources and
flags, so an edit rebuilds and an unchanged tree reuses the last build.
Building takes seconds: no source includes PyTorch's headers.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
LIB_NAME = "libtpu_lbfgs_torch.so"

# -fmad=false keeps nvcc from contracting a*b + c into one fused
# multiply-add, so each kernel rounds exactly where its plain PyTorch
# version does and their output vectors agree bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    "tl_max_blocks": ([], ctypes.c_int),
    "tl_error_string": ([ctypes.c_int], ctypes.c_char_p),
    # body (and hist_bf16): blocks of the kernel per SM of the current device
    "tl_fused_tail_blocks_per_sm": ([ctypes.c_int] * 2, ctypes.c_int),
    "tl_multi_phi_dphi_blocks_per_sm": ([ctypes.c_int], ctypes.c_int),
    # body, x, g, partials, f, n, stream
    "tl_fused_vg_f32": ([ctypes.c_int] + [_P] * 4 + [ctypes.c_longlong, _P],
                        ctypes.c_int),
    # body, hist_bf16, m, compensated, 12 pointers, n, stream
    "tl_fused_tail_f32": ([ctypes.c_int] * 4 + [_P] * 12
                          + [ctypes.c_longlong, _P], ctypes.c_int),
    # the shard-local forms: the same arguments, then n_global, start, edges
    "tl_fused_vg_local_f32": ([ctypes.c_int] + [_P] * 4
                              + [ctypes.c_longlong] * 3 + [_P, _P],
                              ctypes.c_int),
    "tl_fused_tail_local_f32": ([ctypes.c_int] * 4 + [_P] * 12
                                + [ctypes.c_longlong] * 3 + [_P, _P],
                                ctypes.c_int),
    **{f"tl_{k}_local_f32": ([ctypes.c_int] + [_P] * 3
                             + [ctypes.c_int, _P, _P]
                             + [ctypes.c_longlong] * 3 + [_P, _P],
                             ctypes.c_int)
       for k in ("multi_phi", "multi_phi_dphi")},
    # body, x, d, alphas, K, partials, out, n, stream
    **{f"tl_{k}_f32": ([ctypes.c_int] + [_P] * 3 + [ctypes.c_int, _P, _P,
                                                    ctypes.c_longlong, _P],
                       ctypes.c_int)
       for k in ("multi_phi", "multi_phi_dphi")},
    **{f"tl_iteration_tail_{t}": ([_P] * 10 + [ctypes.c_longlong,
                                              ctypes.c_int, _P],
                                  ctypes.c_int)
       for t in ("f32", "f64")},
    **{f"tl_combine_direction_{t}": ([_P] * 7 + [ctypes.c_int,
                                                 ctypes.c_longlong, _P],
                                     ctypes.c_int)
       for t in ("f32", "f64", "f32_bf16")},
    # ... skip_thr, use_thr, spread, the five outputs, B, m, stream.
    **{f"tl_compact_chain_{t}": ([_P] * 8 + [c_thr, ctypes.c_int,
                                            ctypes.c_int] + [_P] * 5
                                 + [ctypes.c_longlong, ctypes.c_int, _P],
                                 ctypes.c_int)
       for t, c_thr in (("f32", ctypes.c_float), ("f64", ctypes.c_double))},
    # The batched forms: the one-instance arguments with lanes before n.
    "tl_fused_vg_batched_f32": ([ctypes.c_int] + [_P] * 4
                                + [ctypes.c_longlong] * 2 + [_P],
                                ctypes.c_int),
    "tl_fused_tail_batched_f32": ([ctypes.c_int] * 4 + [_P] * 12
                                  + [ctypes.c_longlong] * 2 + [_P],
                                  ctypes.c_int),
    **{f"tl_iteration_tail_batched_{t}": ([_P] * 10 + [ctypes.c_longlong] * 2
                                          + [ctypes.c_int, _P], ctypes.c_int)
       for t in ("f32", "f64")},
    **{f"tl_combine_direction_batched_{t}": (
        [_P] * 7 + [ctypes.c_int] + [ctypes.c_longlong] * 2 + [_P],
        ctypes.c_int)
       for t in ("f32", "f64", "f32_bf16")},
    # The WHILE nodes of the gated line-search driver (csrc/graph_if.cu):
    # out; stream; parent, pred, turns, body, body graph out, handle out;
    # body, body graph, handle, pred, turns, nodes; stream, nodes; stream.
    "tl_stream_create": ([_P], ctypes.c_int),
    "tl_stream_destroy": ([_P], ctypes.c_int),
    "tl_graph_while_begin": ([_P] * 6, ctypes.c_int),
    "tl_graph_while_end": ([_P, _P, ctypes.c_ulonglong] + [_P] * 3,
                           ctypes.c_int),
    "tl_capture_nodes": ([_P] * 2, ctypes.c_int),
    "tl_capture_abort": ([_P], ctypes.c_int),
    # The batched shard-local forms: the batched arguments, lanes and n,
    # then n_global, start, edges.
    "tl_fused_vg_local_batched_f32": ([ctypes.c_int] + [_P] * 4
                                      + [ctypes.c_longlong] * 4 + [_P, _P],
                                      ctypes.c_int),
    "tl_fused_tail_local_batched_f32": ([ctypes.c_int] * 4 + [_P] * 12
                                        + [ctypes.c_longlong] * 4
                                        + [_P, _P], ctypes.c_int),
    **{f"tl_{k}_local_batched_f32": ([ctypes.c_int] + [_P] * 3
                                     + [ctypes.c_int, _P, _P]
                                     + [ctypes.c_longlong] * 4 + [_P, _P],
                                     ctypes.c_int)
       for k in ("multi_phi", "multi_phi_dphi")},
}


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").is_file():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built at first use")


def build(csrc: Path = CSRC) -> tuple[Path, float, str]:
    """Compile the kernels if this tree's build is missing.  Returns the
    library's path, the seconds spent compiling (0 when reused) and the
    compiler's report (registers, shared memory and spills per kernel).
    ``csrc`` is another directory of sources with the same interface (a
    parent commit's, for ``bench/kernel_ab.py``); its library lands beside
    this tree's under its own hash.

    Two processes may build at once: each compiles into files named by its
    pid and renames the finished library into place, so a reader sees a
    whole library or none.  A job of several ranks builds once, in the
    parent, before it starts them."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, pid = find_nvcc(), os.getpid()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(csrc.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{pid}.o"   # nvcc goes by the suffix
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = [proc.communicate()[0] for proc in procs]
    report = "".join(outs)
    failed = [(obj, proc.returncode) for obj, proc in zip(objs, procs)
              if proc.returncode != 0]
    tmp = out_dir / f"{LIB_NAME}.{pid}.tmp"
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)],
            capture_output=True, text=True, check=False)
        report += link.stdout + link.stderr
        if link.returncode != 0:
            failed = [(tmp, link.returncode)]
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed}):\n{report}")
    log.write_text(report)
    os.replace(tmp, lib)    # atomic: a concurrent build sees all or nothing
    return lib, seconds, report


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernels' library, built if needed and loaded once per process."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.tl_error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
