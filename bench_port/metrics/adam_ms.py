"""``adam_ms``: the optimizer's device ms a step, the self time of the
``adam_d``, ``adam_c`` and ``adam_g`` spans; see
:mod:`bench_port.spans`."""
from .. import spans

NAMES = ("adam_d", "adam_c", "adam_g")


def read(ctx):
    return spans.per_step_ms(ctx.stretch, NAMES)
