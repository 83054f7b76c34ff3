"""Solver profiling: named wall-clock phases, device traces, solve time
against the horizon.

Counterpart of ``bunmpc_tpu/utils/profiling.py`` (reference
src/motion_planner/kino_dyn.cpp:66-79 ``compute_solve_times`` and
examples/analysis/solve_times_test.py:66-118). A phase that ends on device
work synchronizes its CUDA device before the clock stops (the JAX package's
``block_until_ready``); the trace is ``torch.profiler``'s, CPU and CUDA
activities, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

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


@contextlib.contextmanager
def device_trace(log_dir: str, name: str = "trace.json"):
    """``torch.profiler`` around the block (CPU activities, and CUDA ones
    where a card is present); yields the profiler, whose
    ``key_averages()`` and ``events()`` the caller may read, and writes the
    Chrome trace ``log_dir/name`` on exit."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, name))


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
