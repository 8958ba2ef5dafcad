"""``device_idle_share``: the part of the profiled stretch in which no
kernel, memory copy or memory set ran on the card, in %."""


def read(ctx):
    if not ctx.stretch.device:
        return None
    window = ctx.stretch.end_us - ctx.stretch.start_us
    return 100.0 * (1.0 - ctx.busy_us / window)
