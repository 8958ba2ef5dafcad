"""The penalty's convolutions (``xgan_torch.ops.conv``): each conv of the
critic's forward on x̂ has its input gradient written as a transposed
convolution, so the WGAN-GP penalty's double backward differentiates that
op and never a conv's own backward (``aten::_convolution_double_backward``,
whose weight term is a dilated-filter convolution on the card's CUDA
cores).

- ``conv2d_double_backward`` passes ``gradcheck`` and ``gradgradcheck`` in
  float64, at a k4 s2 p1 conv and at the critic's valid head.
- ``gradient_penalty``'s gradient in the critic's parameters through it
  equals the ``F.conv2d`` path's (float64, a small critic, with and
  without a masked tail), and the profiled backward of that penalty runs
  no ``aten::_convolution_double_backward``.
- ``CALLS`` counts one input gradient a conv a critic update: 25 after a
  WGAN-GP step of 5 critic updates, 0 after a DCGAN step.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from xgan_torch.models.dcgan import Discriminator
from xgan_torch.models.dcgan import Generator as DCGenerator
from xgan_torch.models.wgan import Critic, Generator
from xgan_torch.ops import conv as penalty_conv
from xgan_torch.ops.conv import conv2d_double_backward
from xgan_torch.train.common import adam
from xgan_torch.train.gan import dcgan_step
from xgan_torch.train.wgan import gradient_penalty, wgan_step

torch.set_num_threads(1)

LATENT, FM, SIZE, B = 8, 8, 32, 4


@pytest.mark.parametrize("x_shape, w_shape, stride, padding", [
    ((2, 3, 8, 8), (4, 3, 4, 4), 2, 1),    # a k4 s2 p1 conv
    ((2, 4, 6, 6), (1, 4, 3, 3), 1, 0),    # the valid head, one channel
], ids=["k4s2p1", "valid_head"])
def test_conv2d_double_backward_gradchecks(x_shape, w_shape, stride,
                                           padding):
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(x_shape, dtype=torch.float64, generator=gen) \
        .contiguous(memory_format=torch.channels_last).requires_grad_()
    w = torch.randn(w_shape, dtype=torch.float64, generator=gen,
                    requires_grad=True)

    def conv(x, w):
        return conv2d_double_backward(x, w, stride, padding)

    torch.testing.assert_close(
        conv(x, w), torch.nn.functional.conv2d(x, w, None, stride, padding),
        rtol=0, atol=0)
    assert torch.autograd.gradcheck(conv, (x, w))
    assert torch.autograd.gradgradcheck(conv, (x, w))


class _PlainConvCritic(torch.nn.Module):
    """``critic`` with every forward on ``F.conv2d`` (the parent's path)."""

    def __init__(self, critic):
        super().__init__()
        self.critic = critic

    def forward(self, x, *, train, mask=None, double_backward=False):
        return self.critic(x, train=train, mask=mask)


@pytest.mark.parametrize("valid", [B, B - 1], ids=["no_mask", "masked_tail"])
def test_penalty_gradient_equals_the_plain_conv_path(valid):
    """The penalty and its gradient in the critic's parameters, through
    the transposed-conv input gradients and through ``F.conv2d``'s own
    double backward, from the same float64 critic and inputs; then the
    profiled backward of the penalty runs no conv double backward."""
    gen = torch.Generator().manual_seed(3)
    real, fake = (torch.rand(B, SIZE, SIZE, 3, dtype=torch.float64,
                             generator=gen) * 2 - 1 for _ in range(2))
    alpha = torch.rand(B, 1, 1, 1, dtype=torch.float64, generator=gen)
    mask = None if valid == B else (torch.arange(B) < valid).double()

    def penalty_and_grads(critic):
        params = list(critic.parameters())
        gp = gradient_penalty(critic, real, fake, alpha, 10.0, mask)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            grads = torch.autograd.grad(gp, params)
        return gp, grads, {e.name for e in prof.events()}

    def critic():
        return Critic(3, FM, SIZE, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(1)).double()

    gp, grads, ops = penalty_and_grads(critic())
    gp_plain, grads_plain, ops_plain = penalty_and_grads(
        _PlainConvCritic(critic()))
    torch.testing.assert_close(gp, gp_plain, rtol=1e-12, atol=0)
    for g, g_plain in zip(grads, grads_plain, strict=True):
        torch.testing.assert_close(g, g_plain, rtol=1e-10, atol=1e-12)
    # the plain path is the dilated-filter one; the new path never takes it
    assert "aten::_convolution_double_backward" in ops_plain
    assert "aten::_convolution_double_backward" not in ops


def test_counter_reads_one_input_gradient_a_conv_a_critic_update():
    """25 after one WGAN-GP step of 5 critic updates (5 convs each, in the
    penalty's ``create_graph`` pass alone), 0 after a DCGAN step."""
    gen = torch.Generator().manual_seed(5)
    store = torch.randint(0, 256, (8, SIZE, SIZE, 3), dtype=torch.uint8,
                          generator=gen)
    g = Generator(LATENT, 3, FM, SIZE,
                  generator=torch.Generator().manual_seed(0))
    c = Critic(3, FM, SIZE, generator=torch.Generator().manual_seed(1))
    penalty_conv.reset_call_counts()
    losses = wgan_step(g, c, adam(g.parameters(), 2e-4, 0.5, 0.9),
                       adam(c.parameters(), 2e-4, 0.5, 0.9), store,
                       torch.arange(B), latent_dim=LATENT, critic_iters=5,
                       lambda_gp=10.0,
                       generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(losses).all()
    assert dict(penalty_conv.CALLS) == {"conv2d_input_grad": 25}

    g = DCGenerator(LATENT, 3, FM, SIZE,
                    generator=torch.Generator().manual_seed(0))
    d = Discriminator(3, FM, SIZE, generator=torch.Generator().manual_seed(1))
    penalty_conv.reset_call_counts()
    losses = dcgan_step(g, d, adam(g.parameters(), 2e-4, 0.5),
                        adam(d.parameters(), 2e-4, 0.5), store,
                        torch.arange(B), latent_dim=LATENT,
                        generator=torch.Generator().manual_seed(2))
    assert torch.isfinite(losses).all()
    assert sum(penalty_conv.CALLS.values()) == 0
