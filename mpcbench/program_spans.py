"""The program's own spans and counters (``utils.profiling`` of the port:
``span``, ``count``, ``recording``) against a traced slice, for the
per-layer metrics that read them.

The cell's traced slice runs with recording off. So the first reader that
asks makes one more traced slice under ``profiling.recording()``: a fresh
``mpcbench/drivers`` cell on the same seed, its set-up, then that cell's
own ``traced`` (for the closed loop, on an episode that ends with the
window after the profiled ones). What it recorded, and that slice's trace, are
kept on the context as ``ctx.program`` (a ``Records``). A program without
the recorder, a run without a traced slice, or a slice that fails gives
None, and the readers then report nothing.

The arithmetic: a launch is a host runtime event whose name starts with
``cudaLaunch`` or ``cuLaunch``, put down to the innermost program span
around its start; an idle gap of the device (``trace.gaps``) is cut at the
span boundaries and each piece put down to the innermost span over it.
Time under ``mpc.solve`` and under none of its stages is ``mpc.solve``'s
own; time under no span is "outside".
"""

from __future__ import annotations

import bisect
import copy
import importlib
import time
import traceback
from collections import defaultdict

from . import system
from . import trace as T

STAGES = ("mpc.prep", "mpc.k1", "mpc.fused", "mpc.ik_build", "mpc.k2", "mpc.finish")
DISPATCH = ("mpc.prep", "mpc.ik_build", "mpc.finish")  # the stages made of small PyTorch kernels
LAUNCH = ("cudaLaunch", "cuLaunch")
OUTSIDE = "outside"
DRIVERS = ("solve", "closed_loop")
SIM_DT = 0.001  # the loop's substep (``RolloutConfig.sim_dt``)


def records(ctx):
    """The program's records of this cell (a ``Records``), made once a run;
    None where there is nothing to read."""
    if hasattr(ctx, "program"):
        return ctx.program
    ctx.program = None
    traffic = getattr(ctx, "traffic", None) or {}
    if getattr(ctx, "trace", None) is None or traffic.get("driver") not in DRIVERS:
        return None
    profiling = system.module(system.PROGRAM, "utils.profiling")
    if not hasattr(profiling, "recording"):
        ctx.note("the program records no spans: its stage metrics are not reported")
        return None
    try:
        ctx.program = record(ctx, profiling)
    except Exception:  # the stage metrics are optional; the run's own results stand
        ctx.note("the recorded slice failed; its metrics are not reported:\n"
                 + traceback.format_exc())
    return ctx.program


def record(ctx, profiling) -> Records:
    """One more traced slice of the cell, under ``profiling.recording()``."""
    sub = copy.copy(ctx)
    sub.trace, sub.spans, sub.counters = None, {}, {}
    if ctx.traffic["driver"] == "closed_loop":  # the episode ends with the window after the trace
        cl = dict(ctx.config["closed_loop"])
        windows = int(ctx.traffic["trace_window"]) + int(ctx.traffic["trace_windows"]) + 1
        cl["episode_length"] = min(int(cl["episode_length"]),
                                   windows * int(round(cl["plan_freq"] / SIM_DT)))
        sub.config = dict(ctx.config, closed_loop=cl)
    t0 = time.perf_counter()
    driver = importlib.import_module(f"mpcbench.drivers.{ctx.traffic['driver']}").Cell(sub)
    driver.setup()
    sub.sync()
    t1 = time.perf_counter()
    with profiling.recording() as rec:
        driver.traced(sub)
    del driver
    ctx.free()
    t2 = time.perf_counter()
    out = Records(rec.spans, rec.counters, sub.trace)
    out.report(ctx.note)
    ctx.note(f"the recorded slice: set-up {t1 - t0:.2f} s, traced {t2 - t1:.2f} s, read "
             f"{time.perf_counter() - t2:.2f} s")
    return out


class Records:
    """A recording's spans and counters against the trace of the slice it
    was made in. ``solves``: the ``mpc.solve`` spans that overlap the
    trace's window; ``launches`` and ``idle_us``: launches and idle
    microseconds of the device by innermost span name over the window."""

    def __init__(self, spans, counters, trace: T.Trace):
        self.trace = trace
        t0, t1 = trace.t0, trace.t1
        every_solve = [s for s in spans if s.name == "mpc.solve"]
        self.all_spans = spans
        self.spans = [s for s in spans if s.end > t0 and s.start < t1]
        self.solves = [s for s in self.spans if s.name == "mpc.solve"]
        # one count a solve, in the solves' order: the traced solves' values
        iters = counters.get("mpc.admm_iters_max", [])
        inside = {s.id for s in self.solves}
        self.iters_max = ([v for s, v in zip(every_solve, iters) if s.id in inside]
                          if len(iters) == len(every_solve) else [])
        self.segments = segments(self.spans, t0, t1)
        self.launches, self.idle_us = defaultdict(int), defaultdict(float)
        self.copies = defaultdict(int)  # host-issued copies (cudaMemcpy*), for the stage account
        starts = [a for a, _, _ in self.segments]
        for e in trace.host:
            if e.name.startswith(LAUNCH):
                self.launches[self.segments[_at(starts, e.start)][2]] += 1
            elif e.name.startswith("cudaMemcpy"):
                self.copies[self.segments[_at(starts, e.start)][2]] += 1
        self.gaps = T.gaps(trace.device, t0, t1)
        for a, b in self.gaps:
            for name, us in overlap(self.segments, starts, a, b):
                self.idle_us[name] += us

    def per_solve(self, total: float):
        return total / len(self.solves) if self.solves else None

    def stage_ms(self, name: str):
        """Host milliseconds of the stage ``name``, a traced solve."""
        return self.per_solve(sum(s.end - s.start for s in self.spans if s.name == name) * 1e-3)

    def stage_launches(self, name: str):
        return self.per_solve(self.launches.get(name, 0))

    def dispatch_idle_ms(self):
        return self.per_solve(sum(self.idle_us.get(n, 0.0) for n in DISPATCH) * 1e-3)

    def substeps_idle_pct(self):
        """The device's idle share from each profiled window's
        ``rollout.substeps`` start to the next ``mpc.solve`` start, or the
        trace's end."""
        solve_starts = sorted(s.start for s in self.all_spans if s.name == "mpc.solve")
        spans = []
        for s in self.spans:
            if s.name == "rollout.substeps":
                i = bisect.bisect_right(solve_starts, s.start)
                end = solve_starts[i] if i < len(solve_starts) else self.trace.t1
                spans.append((s.start, min(end, self.trace.t1)))
        total = sum(b - a for a, b in spans)
        if not total:
            return None
        idle = sum(max(0.0, min(b, d) - max(a, c)) for a, b in spans for c, d in self.gaps)
        return 100.0 * idle / total

    def capture_ms(self):
        """Host milliseconds of each ``rollout.capture`` of the recording
        (one an episode), their mean."""
        caps = [s.end - s.start for s in self.all_spans if s.name == "rollout.capture"]
        return sum(caps) / len(caps) * 1e-3 if caps else None

    def report(self, note):
        """The stage account on standard error: launches and idle ms a
        traced solve (a traced window in the loop) by innermost span."""
        n = max(1, len(self.solves))
        names = [x for x in STAGES + ("mpc.solve", "rollout.substeps", "rollout.capture", OUTSIDE)
                 if x in self.launches or x in self.idle_us]
        kernels = sum(not e.name.startswith(("Memcpy", "Memset")) for e in self.trace.device)
        idle = (self.trace.window_s - self.trace.busy_s) * 1e3
        note(f"program spans: {len(self.solves)} traced solves; device kernels {kernels / n:.1f} a "
             f"solve, launches under spans {sum(self.launches.values()) / n:.1f}; device idle "
             f"{idle / n:.4f} ms a solve")
        for x in names:
            note(f"program span {x}: launches {self.launches.get(x, 0) / n:.1f}, copies "
                 f"{self.copies.get(x, 0) / n:.1f}, idle "
                 f"{self.idle_us.get(x, 0.0) * 1e-3 / n:.4f} ms, host "
                 f"{sum(s.end - s.start for s in self.spans if s.name == x) * 1e-3 / n:.4f} ms "
                 "a solve (own time: its children's left out of launches and idle)")
        subs = [s.end - s.start for s in self.all_spans if s.name == "rollout.substeps"]
        if subs:
            note(f"program span rollout.substeps: host ms of each window "
                 f"{[round(u * 1e-3, 4) for u in subs]}")


def segments(spans, t0: float, t1: float):
    """[t0, t1] cut at every span boundary inside it: ``(start, end, name)``
    with the innermost span's name (the latest start among those that cover
    the piece), ``OUTSIDE`` where none does."""
    cuts = sorted({t0, t1} | {x for s in spans for x in (s.start, s.end) if t0 < x < t1})
    out = []
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        inner = max((s for s in spans if s.start <= mid < s.end), key=lambda s: s.start,
                    default=None)
        out.append((a, b, OUTSIDE if inner is None else inner.name))
    return out


def _at(starts, x: float) -> int:
    """The index of the segment that holds ``x``."""
    return max(0, bisect.bisect_right(starts, x) - 1)


def overlap(segs, starts, a: float, b: float):
    """``(name, microseconds)`` of each segment's share of [a, b]."""
    i = _at(starts, a)
    while i < len(segs) and segs[i][0] < b:
        lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
        if hi > lo:
            yield segs[i][2], hi - lo
        i += 1
