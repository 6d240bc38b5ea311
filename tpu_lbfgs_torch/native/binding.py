"""ctypes binding of the C++ oracle, ``native/oracle.cpp`` at the root of
the repository: the reference's sequential L-BFGS in float64 on one host
thread, the CPU baseline of the benchmarks and a trajectory oracle.  The
port's own binding, with the signature of ``tpu_lbfgs.native.binding``.

At first use the source is compiled with the reference binding's command,
``g++ -O3 -std=c++17 -shared -fPIC -march=native`` (so both bindings load
the same machine code on one host and give the same results), into
``tpu_lbfgs_torch/_build/native/<hash>/liboracle.so``, keyed by a hash of
the source, the flags and ``g++ --version``: an edit or another compiler
rebuilds, an unchanged tree reuses the last build.  Each process compiles
to a file named by its pid and renames it into place, so processes that
build at once leave one whole library.  A failed build raises with the
compiler's output.

The oracle runs on the host whatever device the caller uses: x0 is a
numpy array or a CPU tensor, and a tensor on another device raises
``TypeError`` (copy it to the host first).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..config import LBFGSConfig
from ..types import Status

SRC = Path(__file__).resolve().parents[2] / "native" / "oracle.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build" / "native"
LIB_NAME = "liboracle.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-march=native")

PROBLEM_IDS = {"quadratic": 0, "rosenbrock": 1, "coupled_quadratic": 2}

_LS_IDS = {
    "backtracking": 0,
    "backtracking_wolfe": 1,
    "backtracking_wolfe_bisect": 2,
    "armijo_interpolation": 3,
    "wolfe_interpolation": 4,
}

_OBJ_CB = ctypes.CFUNCTYPE(ctypes.c_double, ctypes.POINTER(ctypes.c_double),
                           ctypes.c_int, ctypes.c_void_p)
_GRAD_CB = ctypes.CFUNCTYPE(None, ctypes.POINTER(ctypes.c_double),
                            ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                            ctypes.c_void_p)
_DP = ctypes.POINTER(ctypes.c_double)


def build(force: bool = False) -> Path:
    """The oracle's library, compiled if this source, these flags and this
    compiler have no build yet (or ``force``)."""
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(version.encode())
    h.update(SRC.read_bytes())
    lib = BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME
    if lib.is_file() and not force:
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)    # atomic: a concurrent build sees all or nothing
    return lib


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The oracle's library, built if needed and loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.tl_lbfgs_solve.restype = ctypes.c_int
    lib.tl_lbfgs_solve.argtypes = [
        ctypes.c_int, _OBJ_CB, _GRAD_CB, ctypes.c_void_p,
        _DP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, _DP, _DP, _DP, _DP,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        _DP, _DP, _DP,
    ]
    lib.tl_problem_f.restype = ctypes.c_double
    lib.tl_problem_f.argtypes = [ctypes.c_int, _DP, ctypes.c_int]
    lib.tl_problem_grad.restype = None
    lib.tl_problem_grad.argtypes = [ctypes.c_int, _DP, _DP, ctypes.c_int]
    return lib


def _pack_params(cfg: LBFGSConfig) -> np.ndarray:
    return np.array([
        cfg.c1, cfg.c2, cfg.initial_step, cfg.shrink, cfg.grow,
        cfg.backtracking_tol, cfg.interp_min, cfg.bisect_tol,
        float(cfg.ls_max_iters), float(cfg.ls_safety_cap),
        -1.0 if cfg.alpha_rescue_floor is None else cfg.alpha_rescue_floor,
        cfg.alpha_rescue_value, cfg.step_fail_tol, cfg.curvature_threshold,
        1.0 if cfg.safe_cubic else 0.0,
    ], dtype=np.float64)


def _host_vector(x0) -> np.ndarray:
    """x0 as a contiguous float64 vector on the host."""
    if isinstance(x0, torch.Tensor):
        if x0.device.type != "cpu":
            raise TypeError(
                f"native_lbfgs runs on the host and got x0 on {x0.device}; "
                "copy it to the host first (x0.cpu())")
        x0 = x0.detach().numpy()
    x0 = np.ascontiguousarray(x0, np.float64)
    if x0.ndim != 1:
        raise ValueError(f"x0 must be a vector, got shape {x0.shape}")
    return x0


def native_lbfgs(problem: str, x0, cfg: LBFGSConfig,
                 record_trace: bool = False,
                 f: Optional[Callable] = None,
                 grad: Optional[Callable] = None) -> dict:
    """Solve with the C++ oracle from ``x0`` (a numpy array or a CPU
    tensor) under ``cfg``'s line search, fidelity and constants.
    ``problem`` names a built-in objective ("quadratic" | "rosenbrock" |
    "coupled_quadratic"), or is "custom" with numpy callbacks ``f(x) ->
    float`` and ``grad(x) -> array`` (slower: each evaluation crosses back
    into Python).  Returns x, f, g_norm, iterations, status (a name),
    n_fev, n_gev and, under ``record_trace``, trace_f (f before each
    step), trace_gnorm and trace_alpha."""
    lib = load()
    x0 = _host_vector(x0)
    n = x0.shape[0]

    if problem == "custom":
        pid = -1
        if f is None or grad is None:
            raise ValueError("custom problem needs f and grad callbacks")

        @_OBJ_CB
        def f_cb(xp, nn, _ctx):
            return float(f(np.ctypeslib.as_array(xp, (nn,))))

        @_GRAD_CB
        def g_cb(xp, gp, nn, _ctx):
            g = np.asarray(grad(np.ctypeslib.as_array(xp, (nn,))), np.float64)
            np.ctypeslib.as_array(gp, (nn,))[:] = g
    elif problem in PROBLEM_IDS:
        pid = PROBLEM_IDS[problem]
        f_cb = ctypes.cast(None, _OBJ_CB)
        g_cb = ctypes.cast(None, _GRAD_CB)
    else:
        raise ValueError(f"native_lbfgs has no problem {problem!r}; expected "
                         f"one of {sorted(PROBLEM_IDS)} or 'custom'")
    if cfg.line_search not in _LS_IDS:
        raise ValueError(f"native_lbfgs has no line search "
                         f"{cfg.line_search!r}; expected one of "
                         f"{sorted(_LS_IDS)}")

    x_out = np.empty(n, np.float64)
    f_out = ctypes.c_double()
    gnorm_out = ctypes.c_double()
    iters_out = ctypes.c_int()
    status_out = ctypes.c_int()
    nfev = ctypes.c_long()
    ngev = ctypes.c_long()

    if record_trace:
        tf = np.zeros(cfg.max_iters, np.float64)
        tg = np.zeros(cfg.max_iters, np.float64)
        ta = np.zeros(cfg.max_iters, np.float64)
        tfp, tgp, tap = (t.ctypes.data_as(_DP) for t in (tf, tg, ta))
    else:
        tf = tg = ta = None
        tfp = tgp = tap = ctypes.cast(None, _DP)

    params = _pack_params(cfg)
    lib.tl_lbfgs_solve(
        pid, f_cb, g_cb, None, x0.ctypes.data_as(_DP), n,
        cfg.m, cfg.max_iters, cfg.tol, _LS_IDS[cfg.line_search],
        1 if cfg.fidelity == "reference" else 0, params.ctypes.data_as(_DP),
        x_out.ctypes.data_as(_DP), ctypes.byref(f_out),
        ctypes.byref(gnorm_out), ctypes.byref(iters_out),
        ctypes.byref(status_out), ctypes.byref(nfev), ctypes.byref(ngev),
        tfp, tgp, tap)

    k = int(iters_out.value)
    out = {
        "x": x_out, "f": float(f_out.value), "g_norm": float(gnorm_out.value),
        "iterations": k, "status": Status.NAMES[int(status_out.value)],
        "n_fev": int(nfev.value), "n_gev": int(ngev.value),
    }
    if record_trace:
        out["trace_f"] = tf[:k]
        out["trace_gnorm"] = tg[:k]
        out["trace_alpha"] = ta[:k]
    return out
