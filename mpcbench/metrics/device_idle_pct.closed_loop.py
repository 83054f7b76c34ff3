"""The device's idle share of the traced replanning windows of the closed
loop, in percent: 100 less the union of its kernel, copy and set intervals
over the traced span (each window's solve and its substeps)."""


def read(ctx):
    if ctx.trace is None or "traced_windows" not in ctx.counters:
        return None
    return ctx.trace.idle_pct()
