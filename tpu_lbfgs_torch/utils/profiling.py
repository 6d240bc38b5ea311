"""Device traces of a solve (``tpu_lbfgs.utils.profiling``) over
``torch.profiler``: the host's operations and, on the card, every kernel
with its device time, written as a Chrome / Perfetto trace
(``trace.json``, open in ui.perfetto.dev or chrome://tracing).

The reference's ``trace`` falls back to a no-op where its backend cannot
be profiled.  Here a profiler that cannot start, or that records no
device activity on the card, is an error: a trace without its kernels
would be read as a trace of a solve that launched none.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from ..types import resolve_device


@contextlib.contextmanager
def trace(trace_dir: str, device=None) -> Iterator:
    """Record a ``torch.profiler`` trace of the enclosed block into
    ``trace_dir/trace.json``, with the CUDA activity of the current device
    (``types.resolve_device``: raises without one) or, with
    ``device="cpu"``, the host's only.  Yields the profiler.  Raises when
    the profiler cannot start, or when it saw no kernel on the card; an
    exception of the block itself propagates as it is."""
    from torch.profiler import ProfilerActivity, profile

    dev = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    except BaseException:
        prof.__exit__(None, None, None)
        raise
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    prof.__exit__(None, None, None)
    path = os.path.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    if dev.type == "cuda" and not any(
            getattr(e, "device_time_total", 0) > 0
            for e in prof.key_averages()):
        raise RuntimeError(
            f"torch.profiler recorded no device time on {dev} (trace in "
            f"{path}): the card's activity could not be traced")


def profile_solve(run_fn, *args, trace_dir: Optional[str] = None,
                  warmup: bool = True, device=None) -> dict:
    """Time (and, with ``trace_dir``, trace) one solve: ``run_fn(*args)``
    returns a result whose ``.f`` is read as the fence (its sum for a
    batch), as the reference reads its scalar.  A warm-up call runs first
    outside the trace (the kernels' build and first launches).  Returns
    {"wall_s", "result", "trace_dir"}; the trace is
    ``trace_dir/trace.json``."""
    if warmup:
        float(run_fn(*args).f.sum())
    ctx = trace(trace_dir, device) if trace_dir else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        out = run_fn(*args)
        float(out.f.sum())
    return {"wall_s": time.perf_counter() - t0, "result": out,
            "trace_dir": trace_dir}
