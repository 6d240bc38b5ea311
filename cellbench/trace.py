"""A profiled slice of a run: what the card ran, and when it sat idle.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` and reduces the
device's records to a ``Slice``.  torch.profiler has been seen to drop a
session's first device records on an NVIDIA H100 80GB HBM3, so the session
waits ``PROFILE_EDGE_S`` at each end and launches ``SENTINELS`` spin
kernels on each side of the slice, where the records that could be lost
are; the spins are not counted.  (The technique and its constants are
copied from the program's bring-up check, ``chip_smoke.py``.)

The slice is the host span ``cellbench.slice`` around ``fn``, which starts
after the card has drained and ends with a synchronize: every device
record inside it belongs to ``fn``.  Gaps between the device's busy
intervals are labelled by what the host was doing: the innermost
``cellbench.*`` span over the gap and the longest CUDA runtime call in it.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

PROFILE_EDGE_S = 0.02
SENTINELS = 8
SENTINEL_CYCLES = 100_000
SLICE = "cellbench.slice"
_SPIN = "spin_kernel"
#: Entries kept of each list of the breakdown, and the characters kept of
#: a name (a kernel's name holds its whole template signature).
TOP = 10
NAME_CHARS = 160


@dataclass
class Slice:
    """The device's side of a profiled slice, times in seconds.

    ``ops``: (name, start, end) of every device operation (kernels, copies
    and fills) in the slice, in start order; ``window_s``: the slice's
    length; ``busy_s``: the time in which some operation ran;
    ``gaps``: seconds idle by what the host was doing."""
    ops: list
    window_s: float
    busy_s: float
    gaps: dict = field(default_factory=dict)

    @property
    def kernels(self) -> list:
        """The operations that are kernels (no copies, no fills)."""
        return [op for op in self.ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def calls(self, kernel: str) -> list:
        """The device seconds of each call of ``kernel``: a launch whose
        name holds ``kernel``, with the finishing kernels
        (``finish_*``, the second stage of its sums) that follow it."""
        out, ops = [], self.ops
        for i, (name, start, end) in enumerate(ops):
            if kernel not in name:
                continue
            j = i + 1
            while j < len(ops) and "finish_" in ops[j][0]:
                end = ops[j][2]
                j += 1
            out.append(end - start)
        return out

    def top_ops(self) -> list:
        """[name, seconds] of the operations that took most time."""
        total = defaultdict(float)
        for name, start, end in self.ops:
            total[name] += end - start
        return [[n[:NAME_CHARS], s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def top_gaps(self) -> list:
        return [[n, s] for n, s in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:TOP]]


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def reduce(device_ops, host_spans, window) -> Slice:
    """The ``Slice`` of device records ``device_ops`` [(name, start,
    end)] and host records ``host_spans`` [(name, start, end)], both in
    seconds of one clock, inside ``window`` (start, end)."""
    w0, w1 = window
    # The profiler mirrors a host span on the device's timeline as an
    # annotation: it is no operation.
    ops = sorted((op for op in device_ops
                  if w0 <= op[1] and op[2] <= w1 and _SPIN not in op[0]
                  and not op[0].startswith("cellbench.")),
                 key=lambda op: op[1])
    busy = _merge((s, e) for _, s, e in ops)
    busy_s = sum(e - s for s, e in busy)
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    spans = [h for h in host_spans if h[0].startswith("cellbench.")
             and h[0] != SLICE]
    # Runtime calls come one after another from the host's one thread: the
    # few that start last before a gap ends are the ones that overlap it.
    calls = sorted((h for h in host_spans if h[0].startswith("cuda")),
                   key=lambda h: h[1])
    starts = [h[1] for h in calls]
    gaps = defaultdict(float)
    for start, end in zip(edges[::2], edges[1::2]):
        if end <= start:
            continue
        mid = 0.5 * (start + end)
        inner = [h for h in spans if h[1] <= mid <= h[2]]
        span = min(inner, key=lambda h: h[2] - h[1])[0] if inner \
            else "outside any span"
        last = bisect.bisect_left(starts, end)
        over = [(min(end, h[2]) - max(start, h[1]), h[0])
                for h in calls[max(0, last - 8):last] if h[2] > start]
        call = max(over)[1] if over else "no runtime call"
        gaps[f"{span} / {call}"] += end - start
    return Slice(ops, w1 - w0, busy_s, dict(gaps))


def profiled(fn):
    """(fn's result, its ``Slice``) with ``fn`` run once under
    ``torch.profiler`` on the current CUDA device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_EDGE_S)
        for _ in range(SENTINELS):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        with record_function(SLICE):
            out = fn()
            torch.cuda.synchronize()
        for _ in range(SENTINELS):
            torch.cuda._sleep(SENTINEL_CYCLES)
        torch.cuda.synchronize()
        time.sleep(PROFILE_EDGE_S)
    device, host, window = [], [], None
    for e in prof.events():
        rec = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            device.append(rec)
        else:
            host.append(rec)
            if e.name == SLICE:
                window = rec[1:]
    if window is None:
        raise RuntimeError("torch.profiler recorded no span of the slice")
    return out, reduce(device, host, window)
