"""The traced slice of a run: ``torch.profiler`` over a few steady calls,
read in memory (nothing is written to disk).

``Trace`` holds the device's operations (kernels, copies and sets) and the
host's operations as intervals in microseconds, with the arithmetic the
per-layer readers and the result line share: the device's busy time (the
union of its intervals), its idle share, kernel time by name, and the idle
gaps labelled by the host operation that was running (the innermost one
around the gap's middle).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import NamedTuple

import torch


class Interval(NamedTuple):
    start: float  # microseconds
    end: float
    name: str


def union_us(intervals) -> float:
    """Microseconds covered by the union of ``intervals``."""
    busy, end = 0.0, -float("inf")
    for a, b, *_ in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def gaps(intervals, t0: float, t1: float):
    """The spans of [t0, t1] that no interval covers, as (start, end)."""
    out, end = [], t0
    for a, b, *_ in sorted(intervals):
        if a > end:
            out.append((end, min(a, t1)))
        end = max(end, b)
    if end < t1:
        out.append((end, t1))
    return [(a, b) for a, b in out if b > a]


def kernel_name(signature: str) -> str:
    """``void ddp_kernel<12>(int, ...)`` -> ``ddp_kernel``."""
    head = signature.split("(")[0].split(" ")[-1]
    return head.split("<")[0]


def short(name: str, n: int = 120) -> str:
    """A device operation's name cut to ``n`` characters for the breakdown."""
    return name if len(name) <= n else name[:n - 3] + "..."


class Trace:
    """The intervals of one traced slice. ``device`` and ``host`` are lists
    of ``Interval``; the window is [t0, t1], the span of every event."""

    def __init__(self, device, host, t0=None, t1=None):
        self.device = sorted(device)
        self.host = sorted(host)
        every = self.device + self.host
        self.t0 = min(e.start for e in every) if t0 is None else t0
        self.t1 = max(e.end for e in every) if t1 is None else t1

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_us(self.device) * 1e-6

    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernels(self, name: str):
        """The device intervals of the kernel ``name``: its function's name
        (before the argument list, after any template arguments and return
        type) is ``name``."""
        return [e for e in self.device if kernel_name(e.name) == name]

    def device_ops(self, top: int = 10):
        """The device operations that took most time: [[name, seconds], ...]."""
        total = defaultdict(float)
        for e in self.device:
            total[short(e.name)] += (e.end - e.start) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10):
        """Idle time of the device summed by the innermost host operation
        running at each gap's middle: [[name, seconds], ...], longest first."""
        starts = [e.start for e in self.host]
        total = defaultdict(float)
        for a, b in gaps(self.device, self.t0, self.t1):
            mid, label = 0.5 * (a + b), "no host operation"
            i = bisect.bisect_right(starts, mid)
            for e in reversed(self.host[max(0, i - 4000):i]):  # the latest start is innermost
                if e.end >= mid:
                    label = e.name
                    break
            total[label] += (b - a) * 1e-6
        return [[n, s] for n, s in sorted(total.items(), key=lambda x: -x[1])[:top]]


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _raw_events(prof):
    """``(name, is_device, start_us, end_us)`` of every event the profiler
    kept, read from its raw results (building PyTorch's event tree for the
    hundreds of thousands of kernels a traced closed-loop window launches
    takes minutes)."""
    results = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if results is None:
        for e in prof.events():
            yield e.name, _is_device(e), float(e.time_range.start), float(e.time_range.end)
        return
    cuda = torch.autograd.DeviceType.CUDA
    for e in results.events():
        start = e.start_ns() / 1e3
        yield e.name(), e.device_type() == cuda, start, start + e.duration_ns() / 1e3


def from_profiler(prof) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``."""
    device, host = [], []
    for name, on_device, start, end in _raw_events(prof):
        if end < start:
            continue
        (device if on_device else host).append(Interval(start, end, name))
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    return Trace(device, host)


def profiler():
    """A ``torch.profiler.profile`` of the host and the device."""
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])


@contextlib.contextmanager
def traced():
    """Profile the block (host and device); yields a list that holds the
    ``Trace`` once the block has ended and the device has finished."""
    out = []
    with profiler() as prof:
        yield out
        torch.cuda.synchronize()
    out.append(from_profiler(prof))
