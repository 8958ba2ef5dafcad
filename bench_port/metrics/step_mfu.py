"""``step_mfu``: the whole train step's share of the card's peak, in %.

Model FLOPs a step from the shapes (``bench_port/flops.py``, no
recomputation counted), times the steps of the traced run's unprofiled
window, over that window's seconds, over the card's dense bf16 peak
(``bench_port/peaks.json``). Nothing to read on a card the table lacks."""


def read(ctx):
    if ctx.peaks is None or ctx.window_s <= 0:
        return None
    work = ctx.flops.step(ctx.cfg, ctx.cell["batch"]) * ctx.window_steps
    return 100.0 * work / ctx.window_s / ctx.peaks["flops"]
