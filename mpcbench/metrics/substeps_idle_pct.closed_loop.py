"""The device's idle share of the closed loop's substeps, in percent: over
each profiled window, from its ``rollout.substeps`` span's start to the next
``mpc.solve`` span's start (or the trace's end), the share no kernel, copy
or set covers."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    return None if rec is None else rec.substeps_idle_pct()
