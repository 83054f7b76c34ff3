"""Kernel launches under ``mpc.ik_build`` a traced solve: the trace's host
launch events (``cudaLaunch*``, ``cuLaunch*``) that start inside the
program's ``mpc.ik_build`` spans."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    return None if rec is None else rec.stage_launches("mpc.ik_build")
