"""Build and load the port's CUDA kernels.

The sources under ``tpu_lbfgs_torch/csrc`` have a plain C interface.  At
first use they are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library, which is loaded with ``ctypes``.  The library lands in
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
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P = ctypes.c_void_p
_SIGNATURES = {
    "tl_max_blocks": ([], ctypes.c_int),
    "tl_error_string": ([ctypes.c_int], ctypes.c_char_p),
    "tl_rosenbrock_vg_f32": ([_P, _P, _P, _P, ctypes.c_longlong, _P],
                             ctypes.c_int),
    "tl_rosenbrock_fused_tail_f32": ([_P] * 10 + [ctypes.c_longlong, _P],
                                     ctypes.c_int),
}


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


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


def build() -> tuple[Path, float, str]:
    """Compile the kernels if this tree's build is missing.  Returns the
    library's path, the seconds spent compiling (0 when reused) and the
    compiler's report (registers, shared memory and spills per kernel)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib = out_dir / LIB_NAME
    log = out_dir / "nvcc.log"
    if lib.is_file():
        return lib, 0.0, log.read_text() if log.is_file() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sorted(CSRC.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    report = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{report}")
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
