"""The closed loop's substeps: (the traced episode's time less its window
solves' time) over its steps, in milliseconds a 1 ms step of the whole
batch (the controller, the physics and the records, one CUDA-graph replay)."""


def read(ctx):
    spans = ctx.spans.get("window_solve")
    if not spans or "episode_s" not in ctx.counters:
        return None
    return (ctx.counters["episode_s"] - sum(spans)) / ctx.counters["episode_steps"] * 1e3
