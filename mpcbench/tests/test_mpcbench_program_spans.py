"""The readers of the program's spans and counters on synthetic traces with
program spans and host launch events, counted by hand; each returns None
where there is nothing to read (no traced slice, or a program without the
recorder)."""

import importlib.util
import os
import sys
import types
from typing import NamedTuple

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
sys.path.insert(0, os.path.dirname(BENCH))

from mpcbench import program_spans as P  # noqa: E402
from mpcbench import trace as T  # noqa: E402

READERS = ("prep_ms.solve", "ik_build_ms.solve", "finish_ms.solve", "prep_launches.solve",
           "ik_build_launches.solve", "finish_launches.solve", "dispatch_idle_ms.solve",
           "admm_iters_max.solve", "substeps_idle_pct.closed_loop", "capture_ms.closed_loop")


class Span(NamedTuple):  # the fields of the program's ``profiling.Span``
    name: str
    start: float
    end: float
    id: int
    parent: int | None
    root: int


def spans(*rows):
    """Spans from (name, start, end, parent index) rows, ids in order."""
    out = []
    for i, (name, a, b, parent) in enumerate(rows):
        out.append(Span(name, a, b, i, parent, i if parent is None else out[parent].root))
    return out


def reader(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def solve_records():
    """A warm-up solve before the trace, then one traced solve over [5, 95]
    of the window [0, 100] (microseconds), its five stages inside it."""
    sp = spans(("mpc.solve", -50, -10, None), ("mpc.solve", 5, 95, None),
               ("mpc.prep", 10, 30, 1), ("mpc.k1", 30, 50, 1), ("mpc.ik_build", 50, 60, 1),
               ("mpc.k2", 60, 80, 1), ("mpc.finish", 80, 90, 1))
    dev = [T.Interval(a, b, "k") for a, b in
           ((12, 18), (20, 22), (32, 48), (52, 55), (62, 78), (85, 87), (96, 99))]
    launch = [(11, "cudaLaunchKernel"), (19, "cudaLaunchKernel"), (31, "cudaLaunchKernel"),
              (51, "cudaLaunchKernel"), (53, "cuLaunchKernel"), (61, "cudaLaunchKernel"),
              (84, "cudaLaunchKernelExC"), (7, "cudaLaunchKernel"), (97, "cudaLaunchKernel")]
    host = [T.Interval(0, 100, "outer"), T.Interval(40, 45, "cudaMemcpyAsync")]
    host += [T.Interval(t, t + 0.5, n) for t, n in launch]
    return P.Records(sp, {"mpc.admm_iters_max": [100.0, 42.0]}, T.Trace(dev, host))


def loop_records():
    """A traced window [0, 100]: its solve, then its substeps from 45; the
    next window's solve starts at 120, past the trace's end."""
    sp = spans(("mpc.solve", 0, 40, None), ("rollout.substeps", 45, 60, None),
               ("rollout.capture", 46, 50, 1), ("mpc.solve", 120, 150, None))
    dev = [T.Interval(a, b, "k") for a, b in ((5, 35), (50, 70), (80, 95))]
    return P.Records(sp, {"mpc.admm_iters_max": [7.0, 9.0]},
                     T.Trace(dev, [T.Interval(0, 100, "outer")]))


def test_solve_readers_count_by_hand():
    rec = solve_records()
    # segments: outside [0,5], solve [5,10], prep [10,30], k1 [30,50], ik [50,60], k2 [60,80],
    # finish [80,90], solve [90,95], outside [95,100]
    assert dict(rec.launches) == {"mpc.prep": 2, "mpc.k1": 1, "mpc.ik_build": 2, "mpc.k2": 1,
                                  "mpc.finish": 1, "mpc.solve": 1, "outside": 1}
    # gaps (0,12) (18,20) (22,32) (48,52) (55,62) (78,85) (87,96) (99,100) cut at the segments
    assert dict(rec.idle_us) == pytest.approx({"outside": 7, "mpc.solve": 10, "mpc.prep": 12,
                                               "mpc.k1": 4, "mpc.ik_build": 7, "mpc.k2": 4,
                                               "mpc.finish": 8})
    ctx = types.SimpleNamespace(program=rec)
    got = {name: reader(name).read(ctx) for name in READERS}
    assert got == pytest.approx({
        "prep_ms.solve": 0.020, "ik_build_ms.solve": 0.010, "finish_ms.solve": 0.010,
        "prep_launches.solve": 2, "ik_build_launches.solve": 2, "finish_launches.solve": 1,
        "dispatch_idle_ms.solve": 0.027, "admm_iters_max.solve": 42.0,
        "substeps_idle_pct.closed_loop": None, "capture_ms.closed_loop": None})


def test_loop_readers_count_by_hand():
    ctx = types.SimpleNamespace(program=loop_records())
    # substeps [45, 100]: 55 us, of which idle (45,50) (70,80) (95,100) = 20 us
    assert reader("substeps_idle_pct.closed_loop").read(ctx) == pytest.approx(100 * 20 / 55)
    assert reader("capture_ms.closed_loop").read(ctx) == pytest.approx(0.004)
    assert reader("admm_iters_max.solve").read(ctx) == pytest.approx(7.0)  # the traced solve's
    assert reader("prep_ms.solve").read(ctx) == 0.0  # a solve, no prep span in the window


def test_nothing_to_read_gives_none(monkeypatch):
    empty = types.SimpleNamespace(trace=None, spans={}, counters={})
    for name in READERS:
        assert reader(name).read(types.SimpleNamespace(**vars(empty))) is None, name
    # a traced run of a program without the recorder (no ``recording``) reads nothing
    notes = []
    monkeypatch.setattr(P.system, "module", lambda pkg, name: types.SimpleNamespace())
    ctx = types.SimpleNamespace(trace=solve_records().trace, spans={}, counters={},
                                traffic={"driver": "solve"}, note=notes.append)
    assert all(reader(name).read(ctx) is None for name in READERS)
    assert len(notes) == 1  # the recorded slice is tried once a run
