"""``data_ms``: the input pipeline's device ms a step, the self time of
the program's ``data`` spans (``gather_preprocess`` and the step's
draws); see :mod:`bench_port.spans`."""
from .. import spans

NAMES = ("data",)


def read(ctx):
    return spans.per_step_ms(ctx.stretch, NAMES)
