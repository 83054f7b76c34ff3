"""The device's idle milliseconds a traced solve under the stages made of
small PyTorch kernels: the idle gaps of the trace put down to the innermost
program span, summed over ``mpc.prep``, ``mpc.ik_build`` and
``mpc.finish``."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    return None if rec is None else rec.dispatch_idle_ms()
