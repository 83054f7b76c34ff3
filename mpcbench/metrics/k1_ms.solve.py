"""K1's device time per launch (``csrc/admm.cu``: ``admm_kernel``), in
milliseconds, from the traced slice."""

KERNEL = "admm_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    k = ctx.trace.kernels(KERNEL)
    return sum(e.end - e.start for e in k) / len(k) * 1e-3 if k else None
