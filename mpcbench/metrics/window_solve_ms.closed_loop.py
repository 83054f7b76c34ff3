"""The closed loop's window solve: the mean milliseconds of each
``solve_mpc_batch`` call the traced episode's rollout makes (the
benchmark's host-clock span around each call, the device synchronised on
both sides; the traced run alone wraps the module attribute)."""


def read(ctx):
    spans = ctx.spans.get("window_solve")
    return sum(spans) / len(spans) * 1e3 if spans else None
