"""``rollout.capture``: the host milliseconds of the substep's CUDA-graph
capture and first replay (once a ``rollout_mpc`` call), from the program's
spans over the recorded episode."""

from mpcbench import program_spans


def read(ctx):
    rec = program_spans.records(ctx)
    return None if rec is None else rec.capture_ms()
