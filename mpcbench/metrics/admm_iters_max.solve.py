"""The slowest problem's ADMM iterations, a traced solve: the program's
counter ``mpc.admm_iters_max`` (the largest of a call's iteration counts),
averaged over the traced calls."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    if rec is None or not rec.iters_max:
        return None
    return sum(rec.iters_max) / len(rec.iters_max)
