"""Kernel launches per ``solve_mpc_batch`` call: the device's kernels in the
traced slice (copies and sets left out) over its calls. The main path's
dispatch is almost all problem assembly, the IK build and the interpolation
(the two solver kernels are one launch each)."""


def read(ctx):
    calls = ctx.counters.get("solve_calls")
    if ctx.trace is None or not calls:
        return None
    kernels = [e for e in ctx.trace.device if not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / calls
