"""``mpc.prep`` (``kino_dyn._prepare_problem``, the problem assembly): its
host milliseconds a traced solve, from the program's spans."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    return None if rec is None else rec.stage_ms("mpc.prep")
