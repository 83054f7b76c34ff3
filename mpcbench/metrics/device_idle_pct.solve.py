"""The device's idle share of the traced slice of solve calls, in percent:
100 less the union of its kernel, copy and set intervals over the slice (the
span of every traced event, host and device)."""


def read(ctx):
    if ctx.trace is None or "solve_calls" not in ctx.counters:
        return None
    return ctx.trace.idle_pct()
