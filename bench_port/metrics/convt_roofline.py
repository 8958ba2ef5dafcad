"""``convt_roofline``: the generator's k4s2 ConvT layers against their
bound, in %.

The bound of the five layers of one generator train forward
(``flops.convt_bound_s``: the larger of their FLOPs over the peak FLOP/s
and their bytes over the peak bandwidth, each layer's own work however it
is implemented), times the forwards in the profiled stretch, over the
device time of the kernels whose names hold one of the patterns in
``convt_roofline.json``. Nothing to read where no kernel matches or the
card is not in the table of peaks."""


def read(ctx):
    patterns = ctx.data["kernel_name_contains"]
    spent = sum(b - a for name, _, a, b in ctx.stretch.kernels()
                if any(p in name for p in patterns)) / 1e6
    if spent <= 0 or ctx.peaks is None:
        return None
    forwards = ctx.flops.g_forwards_per_step(ctx.cfg) * ctx.stretch.steps
    bound = ctx.flops.convt_bound_s(ctx.cfg, ctx.cell["batch"], ctx.peaks)
    return 100.0 * bound * forwards / spent
