"""``backward_ms``: the autograd backwards, device ms a step: the self
time of the ``d_backward``, ``g_backward`` (with its two parts,
``d_input_grad`` and ``g_param_grad``), ``gradient_penalty`` (the critic
on x̂ and the input gradient that keeps its graph) and
``critic_backward`` (the double backward) spans; see
:mod:`bench_port.spans`."""
from .. import spans

NAMES = ("d_backward", "g_backward", "d_input_grad", "g_param_grad",
         "gradient_penalty", "critic_backward")


def read(ctx):
    return spans.per_step_ms(ctx.stretch, NAMES)
