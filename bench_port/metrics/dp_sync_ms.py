"""``dp_sync_ms``: the process group's device ms a step, the self time
of the ``dp_sync`` spans (``all_reduce_grads``) and of ``bn_moments``
(BN's moments across ranks, forward); see :mod:`bench_port.spans`."""
from .. import spans

NAMES = ("dp_sync", "bn_moments")


def read(ctx):
    return spans.per_step_ms(ctx.stretch, NAMES)
