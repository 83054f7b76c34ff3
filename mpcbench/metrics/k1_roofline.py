"""K1's share of its roofline, in percent: the least time the card could
take for the traced slice's K1 work (the larger of its counted operations
over 67 TFLOP/s and its counted bytes over 3.35 TB/s, ``mpcbench.work``)
over K1's device time in the slice. The operations follow the ADMM and
F-step FISTA iterations the kernel ran on those inputs."""

from mpcbench import work

KERNEL = "admm_kernel"


def read(ctx):
    if ctx.trace is None or "k1_ops" not in ctx.counters:
        return None
    k = ctx.trace.kernels(KERNEL)
    if not k:
        return None
    seconds = sum(e.end - e.start for e in k) * 1e-6
    return work.roofline_pct(ctx.counters["k1_bytes"], ctx.counters["k1_ops"], seconds)
