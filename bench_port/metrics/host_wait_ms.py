"""``host_wait_ms``: the device's wait on the host inside the program's
spans, ms a step: the stretch's idle gaps, each put by its middle to the
innermost span whose host interval holds it, summed over the gaps that
fall in a span, over the stretch's steps; see
:mod:`bench_port.spans`."""
from .. import spans


def read(ctx):
    return spans.host_wait_ms(ctx.stretch)
