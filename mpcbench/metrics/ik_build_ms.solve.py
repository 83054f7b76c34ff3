"""``mpc.ik_build`` (``kino_dyn._build_ik_tasks`` and ``ik.dense_weights``):
its host milliseconds a traced solve, from the program's spans."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    return None if rec is None else rec.stage_ms("mpc.ik_build")
