"""``forward_ms``: the models' forwards, device ms a step: the self time
of the ``g_forward``, ``d_forward``, ``critic_forward`` and
``g_loss_forward`` spans (BN's moments across ranks, ``bn_moments``, go
to ``dp_sync_ms``); see :mod:`bench_port.spans`."""
from .. import spans

NAMES = ("g_forward", "d_forward", "critic_forward", "g_loss_forward")


def read(ctx):
    return spans.per_step_ms(ctx.stretch, NAMES)
