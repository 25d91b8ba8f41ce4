"""One bounded profiler slice and its reduction: device busy time, launches,
kernel time by name, and the longest idle gaps named by the host op that
the profiler shows in them.

The busy time is the frozen arithmetic of `chip_smoke.py device_idle_share`:
the union of the intervals in which a kernel, a copy or a set ran on the
card, within the slice's window on the host clock.  The trace is never
written to disk; the raw events are read from the profiler in memory.
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class Slice:
    """What one traced slice saw.  Times in seconds, on the profiler's clock
    (nanoseconds since its epoch, divided by 1e9)."""

    window_s: float
    device: list  # (start, end, name) of every kernel, copy and set on the card
    host: list  # (start, end, name) of every host op
    images: int
    counters: dict = dataclasses.field(default_factory=dict)


def busy_seconds(device: list) -> float:
    """Length of the union of the device intervals."""
    busy, end = 0.0, float("-inf")
    for lo, hi, _ in sorted(device):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def top_device_ops(device: list, n: int = 10) -> list:
    """[[name, seconds], ...]: the n device operations with the most summed
    time, names cut to 120 characters."""
    total: dict = {}
    for lo, hi, name in device:
        total[name] = total.get(name, 0.0) + (hi - lo)
    ranked = sorted(total.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:120], secs] for name, secs in ranked]


def idle_gaps(device: list, host: list, n: int = 10) -> list:
    """[[name, seconds], ...]: the n longest gaps between device activity,
    each named by the host op that covers most of it ("host code" where no
    op of the profiler's covers any of it: Python, numpy or the native
    runtime, which the profiler does not see)."""
    gaps, end = [], None
    for lo, hi, _ in sorted(device):
        if end is not None and lo > end:
            gaps.append((lo - end, end, lo))
        end = hi if end is None else max(end, hi)
    gaps.sort(reverse=True)
    host = sorted(host)
    out = []
    for length, lo, hi in gaps[:n]:
        best, name = 0.0, "host code"
        for a, b, op in host:
            if a >= hi:
                break
            cover = min(b, hi) - max(a, lo)
            if cover > best:
                best, name = cover, op
        out.append([name[:120], length])
    return out


def profile_slice(fn) -> Slice:
    """Run `fn()` (it returns the number of images it encoded) under
    `torch.profiler` with host and CUDA activity, and collect the raw
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        images = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in prof.profiler.kineto_results.events():
        lo = ev.start_ns() / 1e9
        span = (lo, lo + ev.duration_ns() / 1e9, ev.name())
        (device if ev.device_type() == cuda else host).append(span)
    return Slice(window_s=window_s, device=device, host=host, images=images)
