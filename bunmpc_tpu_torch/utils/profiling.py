"""Solver profiling: named wall-clock phases, device traces, solve time
against the horizon, and the program's own spans and counters.

Counterpart of ``bunmpc_tpu/utils/profiling.py`` (reference
src/motion_planner/kino_dyn.cpp:66-79 ``compute_solve_times`` and
examples/analysis/solve_times_test.py:66-118). A phase that ends on device
work synchronizes its CUDA device before the clock stops (the JAX package's
``block_until_ready``); the trace is ``torch.profiler``'s, CPU and CUDA
activities, written as a Chrome trace.

Spans and counters (``span``, ``count``) mark the layers of the main path:
the five stages of ``kino_dyn.solve_mpc_batch`` and the closed loop's
substeps and graph capture. They record only inside ``recording()``;
outside it each is one check of a module-level variable. A span's start
and end are ``time.time_ns()`` readings, the clock of ``torch.profiler``'s
events (Unix-epoch nanoseconds), so a profiler trace and a recording of
the same block share a time base. Spans are never profiler ranges
(``record_function``, NVTX): on CUDA such a range is also a device event,
and it would change the trace it is meant to explain.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

import torch


def _block(x):
    """Wait for the CUDA devices of the tensors in ``x`` (a tensor or a
    nesting of lists, tuples, dicts and named tuples of them)."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _block(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _block(v)


class SolveTimer:
    """Accumulates named phase durations; mirrors the reference's
    dyn/kin/total breakdown. Pass ``block_on`` (the phase's output tensors)
    so that asynchronous launches do not hide the cost."""

    def __init__(self):
        self.times = defaultdict(list)

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block(block_on)
            self.times[name].append(time.perf_counter() - t0)

    def summary(self):
        return {
            k: {
                "mean": sum(v) / len(v),
                "min": min(v),
                "max": max(v),
                "count": len(v),
            }
            for k, v in self.times.items()
        }

    def report(self):
        lines = []
        for k, s in self.summary().items():
            lines.append(
                f"{k:>12}: mean {s['mean']*1e3:8.2f} ms  min {s['min']*1e3:8.2f}"
                f"  max {s['max']*1e3:8.2f}  (n={s['count']})"
            )
        return "\n".join(lines)


class Span(NamedTuple):
    """A recorded span: ``start`` and ``end`` in microseconds of the Unix
    epoch (the time base of ``torch.profiler``'s events), its ``id`` (its
    index in ``Recording.spans``), the id of the span around it
    (``parent``, None at the top) and of the outermost span around it
    (``root``, its own id at the top): the spans of one solve share the
    root of its ``mpc.solve``."""

    name: str
    start: float
    end: float
    id: int
    parent: int | None
    root: int


_NO_SPAN = contextlib.nullcontext()  # what ``span`` returns outside a recording
_RECORDING = None  # the Recording in progress, or None
_TRACES = []  # one list per open device_trace: the recordings that end inside it


class _OpenSpan:
    __slots__ = ("rec", "name", "entry")

    def __init__(self, rec, name):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        sid = len(rec._raw)
        parent = rec._stack[-1] if rec._stack else None
        root = sid if parent is None else rec._raw[parent][5]
        self.entry = [self.name, 0, 0, sid, parent, root]
        rec._raw.append(self.entry)
        rec._stack.append(sid)
        self.entry[1] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.entry[2] = time.time_ns()
        self.rec._stack.pop()
        return False


class Recording:
    """The spans and counters of one ``recording()`` block, on the thread
    that opened it. After the block: ``spans``, a list of ``Span`` in the
    order they started, and ``counters``, name -> the values ``count``
    stored under it, in order, as floats (a tensor reduced to its largest
    element)."""

    def __init__(self):
        self.thread = threading.get_ident()
        self.spans, self.counters = [], {}
        self._raw, self._stack, self._counts = [], [], defaultdict(list)

    def _finish(self):
        self.spans = [Span(n, t0 / 1e3, t1 / 1e3, i, p, r) for n, t0, t1, i, p, r in self._raw]
        kept = [v for vs in self._counts.values() for v in vs if isinstance(v, torch.Tensor)]
        largest = iter(())
        if kept:  # one transfer for every kept tensor: the recording's only sync
            dev = kept[0].device
            largest = iter(torch.stack([v.detach().max().to(dev, torch.float64)
                                        for v in kept]).tolist())
        self.counters = {k: [next(largest) if isinstance(v, torch.Tensor) else float(v)
                             for v in vs] for k, vs in self._counts.items()}


def span(name: str):
    """A context manager around one layer's work. Inside ``recording()``
    (on its thread) it records a ``Span``; otherwise it is a shared no-op
    that allocates nothing, reads no clock and never synchronizes."""
    rec = _RECORDING
    if rec is None or rec.thread != threading.get_ident():
        return _NO_SPAN
    return _OpenSpan(rec, name)


def count(name: str, value):
    """Store ``value`` (a number, or a tensor kept as it is and reduced to
    its largest element when the recording ends) under ``name``. Outside
    ``recording()`` it does nothing."""
    rec = _RECORDING
    if rec is not None and rec.thread == threading.get_ident():
        rec._counts[name].append(value)


@contextlib.contextmanager
def recording():
    """Record the block's spans and counters: yields a ``Recording``,
    complete once the block has ended. One recording at a time."""
    global _RECORDING
    if _RECORDING is not None:
        raise RuntimeError("a recording is already in progress")
    rec = _RECORDING = Recording()
    try:
        yield rec
    finally:
        _RECORDING = None
        rec._finish()
        for seen in _TRACES:
            seen.append(rec)


def _add_span_track(path: str, spans):
    """Write ``spans`` into the Chrome trace at ``path`` as one more
    process ("program spans") on the trace's time base."""
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"]
    pid = 1 + max((e["pid"] for e in events if isinstance(e.get("pid"), int)), default=0)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    events.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                   "args": {"name": "program spans"}})
    for s in spans:
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": 0,
                       "ts": s.start - base_us, "dur": s.end - s.start,
                       "args": {"id": s.id, "parent": s.parent, "root": s.root}})
    with open(path, "w") as fh:
        json.dump(trace, fh)


@contextlib.contextmanager
def device_trace(log_dir: str, name: str = "trace.json"):
    """``torch.profiler`` around the block (CPU activities, and CUDA ones
    where a card is present); yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read, and writes the
    Chrome trace ``log_dir/name`` on exit, with the spans of every
    ``recording()`` that ended inside the block as one more track."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    seen = []
    _TRACES.append(seen)
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    finally:
        _TRACES.remove(seen)
    path = os.path.join(log_dir, name)
    prof.export_chrome_trace(path)
    spans = [s for rec in seen for s in rec.spans]
    if spans:
        _add_span_track(path, spans)


def solve_times_sweep(solve_fn, make_args, horizons, n_rep: int = 3):
    """Mean wall seconds of a solve at each horizon (reference
    analysis/solve_times_test.py:66-118): ``solve_fn(horizon)`` returns the
    callable and ``make_args(horizon)`` its inputs; one untimed call first
    (the kernels' build and the allocator's warm-up), then ``n_rep`` timed
    ones, each waited for."""
    out = {}
    for h in horizons:
        fn = solve_fn(h)
        args = make_args(h)
        _block(fn(*args))
        t0 = time.perf_counter()
        for _ in range(n_rep):
            _block(fn(*args))
        out[h] = (time.perf_counter() - t0) / n_rep
    return out
