"""K2's share of its roofline, in percent: the least time the card could
take for the traced slice's K2 work (its fixed operations and bytes at its
shapes and ``DdpConfig``, ``mpcbench.work``) over K2's device time in the
slice."""

from mpcbench import work

KERNEL = "ddp_kernel"


def read(ctx):
    if ctx.trace is None or "k2_ops" not in ctx.counters:
        return None
    k = ctx.trace.kernels(KERNEL)
    if not k:
        return None
    seconds = sum(e.end - e.start for e in k) * 1e-6
    return work.roofline_pct(ctx.counters["k2_bytes"], ctx.counters["k2_ops"], seconds)
