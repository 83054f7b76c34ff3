"""``mpc.finish`` (``kino_dyn._finish_from_ik``, the 1 kHz interpolation and
the plan): its host milliseconds a traced solve, from the program's spans."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    return None if rec is None else rec.stage_ms("mpc.finish")
