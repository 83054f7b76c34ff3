"""``parallel.mesh.gather_batch`` on rank 0: the mean milliseconds of each
traced call's gather of every rank's plans (the benchmark's host-clock span
around the gather, the card synchronised on both sides)."""


def read(ctx):
    spans = ctx.spans.get("gather")
    return sum(spans) / len(spans) * 1e3 if spans else None
