"""``kernels_per_step``: CUDA kernels the profiled stretch ran, over the
train steps in it (eager launches and kernels replayed from a graph
alike)."""


def read(ctx):
    n = len(ctx.stretch.kernels())
    return n / ctx.stretch.steps if n else None
