"""WGAN-GP generator and critic (role of xgan/models/wgan.py).

Generator: the DCGAN generator (``xgan_torch.models.dcgan.Generator``) one
width up, fg*16 -> fg*8 -> fg*4 -> fg*2 -> fg -> C: the reference keeps
one ``nn.Sequential`` layout for both, so the state-dict keys, the eval
and train forwards and the k4s2 ConvT kernel are the DCGAN generator's.

Critic: NHWC (B, S, S, C) -> four Conv(k4, s2, p1) without bias, widths
fd -> fd*2 -> fd*4 -> fd*8, BN on all but the first, LeakyReLU 0.2 ->
Conv(k=S/32, valid) to one channel -> the mean over its spatial map (8x8
at 224 px) -> f32 scores (B,). No sigmoid. Conv at ``main.{0,2,5,8,11}``
and BN at ``main.{3,6,9}``, the reference layout, so a reference
``.pth`` loads with ``strict=True``. The convolutions are cuDNN's, as in
the DCGAN discriminator. The gradient penalty's forward on x̂
(``double_backward=True``, ``xgan_torch.train.wgan``) is the one whose
input gradient is differentiated again: there each conv's input gradient
is a transposed convolution on the graph
(:mod:`xgan_torch.ops.conv`), so the second differentiation runs cuDNN's
weight-gradient and forward kernels and never a conv's own double
backward; every other forward takes plain ``F.conv2d``.

Under tensor parallelism (:func:`xgan_torch.parallel.tp.shard_over_model`)
both nets take the DCGAN layout (:mod:`xgan_torch.models.dcgan`): each
wide layer column-parallel, its output channels and its BN split over the
model group. At the reference widths (fg = fd = 64, N = 2) that is G's
first ConvT, its first two k4s2 ConvTs (1024 -> 512 and 512 -> 256, the
kernel run on each rank's half of Cout) and their BNs, and the critic's
last two k4s2 convs (-> 256, -> 512) and their BNs; the critic's valid
head (512 -> 1) stays whole and gathers its input.
"""
from __future__ import annotations

import torch
from torch import nn

from xgan_torch.models import dcgan
from xgan_torch.models.layers import gan_init_
from xgan_torch.ops.reduce import at_least_f32

SEQ_C_CONV = (0, 2, 5, 8, 11)
SEQ_C_BN = (3, 6, 9)


class Generator(dcgan.Generator):
    def __init__(self, latent_dim: int = 100, num_channels: int = 3,
                 feature_maps: int = 64, image_size: int = 224, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """Arguments as for ``xgan_torch.models.dcgan.Generator``."""
        fg = feature_maps
        super().__init__(latent_dim, num_channels, feature_maps, image_size,
                         widths=[fg * 16, fg * 8, fg * 4, fg * 2, fg],
                         dtype=dtype, device=device, generator=generator)


class Critic(nn.Module):
    def __init__(self, num_channels: int = 3, feature_maps: int = 64,
                 image_size: int = 224, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """``dtype`` and ``generator`` as for the generator."""
        super().__init__()
        dcgan._check_size(image_size)
        self.dtype = dtype
        fd = feature_maps
        widths = [fd, fd * 2, fd * 4, fd * 8]
        layers = [nn.Conv2d(num_channels, widths[0], 4, 2, 1, bias=False,
                            device=device), nn.LeakyReLU(0.2, True)]
        for cin, cout in zip(widths, widths[1:]):
            layers += [nn.Conv2d(cin, cout, 4, 2, 1, bias=False,
                                 device=device),
                       nn.BatchNorm2d(cout, device=device),
                       nn.LeakyReLU(0.2, True)]
        layers += [nn.Conv2d(widths[-1], 1, image_size // 32, 1, 0,
                             bias=False, device=device)]
        self.main = nn.Sequential(*layers)
        gan_init_(self.main, generator)

    def forward(self, x: torch.Tensor, *, train: bool, mask=None,
                double_backward: bool = False) -> torch.Tensor:
        """x (B, S, S, C) NHWC, any float dtype (cast to ``self.dtype``) ->
        f32 scores (B,) (float64 for a float64 critic). ``mask``: (B,)
        validity weights for train-mode BN statistics.
        ``double_backward``: the forward whose input gradient is
        differentiated again (the penalty's, on x̂): each conv's input
        gradient is then a transposed convolution on the graph
        (:func:`~xgan_torch.ops.conv.conv2d_double_backward`)."""
        x = dcgan.conv_ladder(self.main, SEQ_C_CONV, SEQ_C_BN, x, self.dtype,
                              train=train, mask=mask,
                              tp=getattr(self, "tp", None),
                              double_backward=double_backward)
        return at_least_f32(x).mean(dim=(1, 2, 3))


# the reference's name for the critic
Discriminator = Critic
