"""Conditional GAN generator and projection discriminator
(role of xgan/models/cgan.py).

Generator: ``z + label_emb[label]`` -> ``fc`` (latent -> nf*8*S0*S0),
viewed CHW as (B, nf*8, S0, S0) -> BN + ReLU -> 5 x [nearest-2x upsample,
Conv3x3 (s1, p1, bias)] with BN + ReLU between, tanh last; widths nf*8 ->
nf*4 -> nf*2 -> nf -> nf//2 -> C. Output NHWC (B, S, S, C) f32 in [-1, 1].

Projection discriminator: NHWC (B, S, S, C) -> five Conv(k4, s2, p1) with
bias, widths nf//2 -> nf -> nf*2 -> nf*4 -> nf*8, BN after all but the
first, LeakyReLU 0.2 after each; the logit is the final Conv(k=S0, valid)
output (f32) plus the f32 dot of ``label_emb[label]`` with the CHW flatten
of the last LeakyReLU map. ``features=True`` also returns the 14
activations of the feature-matching loss, with the reference's in-place
aliasing kept (its ``LeakyReLU(inplace=True)`` rewrites the tensor it
already appended): ``[lrelu0, lrelu0] + Σ_i [conv_i, lrelu_i, lrelu_i]``,
``conv_i`` the pre-BN conv output with its bias. NCHW tensors.

Parameters live in the reference ``nn.Sequential`` layouts, so ``.pth``
files load with ``strict=True`` both ways: G's ``label_emb``, ``fc`` and
``main`` (BN at ``main.{0,4,8,12,16}``, convs at ``main.{3,7,11,15,19}``),
D's ``label_emb`` and ``main`` (convs at ``main.{0,2,5,8,11,14}``, BNs at
``main.{3,6,9,12}``). Those modules only hold parameters. Init: N(0, 0.02)
conv weights, N(1, 0.02) BN scales, torch's default U(±1/sqrt(fan_in))
conv biases and ``fc``, N(0, 1) embeddings, all from the caller's
``torch.Generator``.

Dtype policy as in the JAX package: each conv and ``fc`` in the compute
``dtype`` with f32 accumulation, rounded to ``dtype``, the bias added in
``dtype``; BN statistics and affine in f32; tanh and the projection in
f32. The convolutions are cuDNN's on channels_last tensors (no Pallas
kernel is on this path in the JAX package either). The label embeddings
are read with ``F.embedding``, whose CUDA backward sums a row's
gradients in a fixed order (``index_select``'s adds them atomically, so
a step's result would vary from run to run on the card).

Under tensor parallelism (:func:`xgan_torch.parallel.tp.shard_over_model`
sets ``tp``, the model group, and slices the leaves the rule makes wide)
each wide conv is column-parallel, its weight, bias and BN split over the
model group on their output channels, its input gathered whole where the
previous layer left a slice (:func:`~xgan_torch.parallel.tp.layer_input`).
G's ``fc`` is the one layer whose bias the rule slices without its weight:
the rule reads a dense kernel's I (the latent, under 256 at the reference
widths) but the bias's C*S0*S0 entries, so every rank computes all of
``fc``'s outputs and adds the bias gathered whole (a weight sliced at a
latent of 256 or more is row-parallel). The CHW bias slice need not line
up with BN ``main.0``'s channels, and the JAX package's HWC bias
(xgan/models/cgan.py:57-58) slices other entries, so whole states are
what compares. Where BN ``main.0`` is sliced, its input is this rank's
channel slice of ``fc``'s output. D's feature-matching taps of a sliced
layer (``conv_i`` and ``lrelu_i``) are gathered whole in the
``features=True`` forward, so the loss over them is one process's on
every rank of the model group; its projection and valid head read the
whole last map, gathered once. The label embeddings stay whole (their
rule dimension is the 2 classes). At the reference widths (nf 32, 224
px, N = 2) the rule slices G's ``fc.bias`` and BN ``main.0`` and D's
``main.11`` (128 -> 256, its bias) and BN ``main.12``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from xgan_torch.models.dcgan import _check_size
from xgan_torch.models.layers import batch_norm, gan_init_, leaky_relu
from xgan_torch.parallel.tp import (gather_from_model, layer_input,
                                    reduce_from_model, sharded,
                                    split_to_model)

SEQ_G_CONV = (3, 7, 11, 15, 19)
SEQ_G_BN = (0, 4, 8, 12, 16)
SEQ_D_CONV = (0, 2, 5, 8, 11, 14)
SEQ_D_BN = (3, 6, 9, 12)
# the biases right before a train-mode BN: their gradient is 0 in exact
# arithmetic, so its norm is rounding noise
G_PRE_BN_BIASES = ("fc.bias",) + tuple(f"main.{s}.bias"
                                       for s in SEQ_G_CONV[:-1])
D_PRE_BN_BIASES = tuple(f"main.{s}.bias" for s in SEQ_D_CONV[1:-1])


@torch.no_grad()
def _init_(main: nn.Sequential, label_emb: nn.Embedding,
           generator: torch.Generator | None) -> None:
    """The reference init of a CGAN ``main`` and its embedding."""
    gan_init_(main, generator)
    for m in main:
        if isinstance(m, nn.Conv2d):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    nn.init.normal_(label_emb.weight, 0.0, 1.0, generator=generator)


def _conv(conv: nn.Conv2d, x: torch.Tensor, stride: int,
          padding: int) -> torch.Tensor:
    """``conv`` on NCHW ``x`` in ``x.dtype``: the product rounded, then
    the bias added in that dtype."""
    y = F.conv2d(x, conv.weight.to(x.dtype), None, stride, padding)
    return y + conv.bias.to(x.dtype).view(1, -1, 1, 1)


class Generator(nn.Module):
    def __init__(self, latent_dim: int = 100, num_classes: int = 2,
                 num_channels: int = 3, feature_maps: int = 32,
                 image_size: int = 224, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """``dtype``: compute dtype of activations (parameters stay f32).
        ``generator`` draws the init; it must live on ``device``."""
        super().__init__()
        _check_size(image_size)
        self.latent_dim = latent_dim
        self.num_classes = num_classes
        self.s0 = image_size // 32
        self.dtype = dtype
        nf = feature_maps
        self.label_emb = nn.Embedding(num_classes, latent_dim, device=device)
        self.fc = nn.Linear(latent_dim, nf * 8 * self.s0 * self.s0,
                            device=device)
        widths = [nf * 8, nf * 4, nf * 2, nf, nf // 2]
        layers = [nn.BatchNorm2d(widths[0], device=device), nn.ReLU(True)]
        for cin, cout in zip(widths, widths[1:]):
            layers += [nn.Upsample(scale_factor=2),
                       nn.Conv2d(cin, cout, 3, 1, 1, device=device),
                       nn.BatchNorm2d(cout, device=device), nn.ReLU(True)]
        layers += [nn.Upsample(scale_factor=2),
                   nn.Conv2d(widths[-1], num_channels, 3, 1, 1,
                             device=device), nn.Tanh()]
        self.main = nn.Sequential(*layers)
        _init_(self.main, self.label_emb, generator)
        with torch.no_grad():
            bound = 1.0 / math.sqrt(latent_dim)
            nn.init.uniform_(self.fc.weight, -bound, bound,
                             generator=generator)
            nn.init.uniform_(self.fc.bias, -bound, bound,
                             generator=generator)

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        self.dtype = dtype

    @torch.no_grad()
    def forward(self, z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """Eval forward (running BN statistics): z (B, latent), labels (B,)
        int -> images (B, S, S, C) in [-1, 1], f32."""
        return self._run(z, labels, train=False, mask=None)

    def forward_train(self, z: torch.Tensor, labels: torch.Tensor,
                      mask=None, *, update_stats: bool = True
                      ) -> torch.Tensor:
        """Train forward, differentiable in the parameters: BN with batch
        statistics (the running ones advance once, or not at all with
        ``update_stats=False``). ``mask``: (B,) validity weights of a
        padded tail batch for the BN statistics (masked rows' outputs are
        garbage by contract)."""
        return self._run(z, labels, train=True, mask=mask,
                         update_stats=update_stats)

    def _run(self, z, labels, *, train: bool, mask,
             update_stats: bool = True) -> torch.Tensor:
        dt, b = self.dtype, z.shape[0]
        tp = getattr(self, "tp", None)
        x = z.float() + F.embedding(labels.long(), self.label_emb.weight)
        x = self._fc(x.to(dt), tp)
        x = x.view(b, -1, self.s0, self.s0) \
            .contiguous(memory_format=torch.channels_last)
        if sharded(self.main[SEQ_G_BN[0]].weight):
            x = split_to_model(x, tp, 1)  # BN and ReLU on this rank's slice
        x = torch.relu(batch_norm(self.main[SEQ_G_BN[0]], x, train=train,
                                  mask=mask, update_stats=update_stats))
        for i, seq in enumerate(SEQ_G_CONV):
            conv = self.main[seq]
            # all channels (gathered where a slice), then the upsample
            x = layer_input(x, conv.weight.shape[1], tp, sharded(conv.weight))
            x = _conv(conv, F.interpolate(x, scale_factor=2, mode="nearest"),
                      1, 1)
            if i < 4:
                x = torch.relu(batch_norm(self.main[seq + 1], x, train=train,
                                          mask=mask,
                                          update_stats=update_stats))
        # channels_last NCHW -> NHWC, a view unless a 1x1 map at S0 = 1
        # lost the channels_last strides on the way
        return torch.tanh(x.float()).permute(0, 2, 3, 1).contiguous()

    def _fc(self, x: torch.Tensor, tp) -> torch.Tensor:
        """``fc`` of the (B, latent) input ``x`` (the same on every rank of
        a model group) in ``x.dtype``: all of its outputs, the product
        rounded, then the bias added. Under tensor parallelism a sliced
        weight (the rule's I, a latent of at least ``MIN_FEATURES``) is
        row-parallel, its partial products summed over the model group;
        a sliced bias (its C*S0*S0 entries, whatever the weight) is
        gathered whole, and its gradient keeps this rank's slice."""
        w, bias = self.fc.weight, self.fc.bias
        if sharded(w):
            y = reduce_from_model(F.linear(split_to_model(x, tp, 1),
                                           w.to(x.dtype)), tp)
        else:
            y = F.linear(x, w.to(x.dtype))
        if sharded(bias):
            bias = gather_from_model(bias, tp, 0)
        return y + bias.to(x.dtype)


class Discriminator(nn.Module):
    def __init__(self, num_classes: int = 2, num_channels: int = 3,
                 feature_maps: int = 32, image_size: int = 224, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """Arguments as for :class:`Generator`."""
        super().__init__()
        _check_size(image_size)
        self.dtype = dtype
        nf, s0 = feature_maps, image_size // 32
        self.label_emb = nn.Embedding(num_classes, nf * 8 * s0 * s0,
                                      device=device)
        widths = [nf // 2, nf, nf * 2, nf * 4, nf * 8]
        layers = [nn.Conv2d(num_channels, widths[0], 4, 2, 1, device=device),
                  nn.LeakyReLU(0.2, True)]
        for cin, cout in zip(widths, widths[1:]):
            layers += [nn.Conv2d(cin, cout, 4, 2, 1, device=device),
                       nn.BatchNorm2d(cout, device=device),
                       nn.LeakyReLU(0.2, True)]
        layers += [nn.Conv2d(widths[-1], 1, s0, 1, 0, device=device)]
        self.main = nn.Sequential(*layers)
        _init_(self.main, self.label_emb, generator)

    def forward(self, x: torch.Tensor, labels: torch.Tensor, *, train: bool,
                features: bool = False, mask=None):
        """x (B, S, S, C) NHWC, any float dtype (cast to ``dtype``),
        labels (B,) int -> f32 logits (B,), or ``(logits, feats)`` with
        ``features=True`` (see the module docstring). ``mask``: (B,)
        validity weights for train-mode BN statistics."""
        b = x.shape[0]
        tp = getattr(self, "tp", None)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = []
        for seq in SEQ_D_CONV[:-1]:
            conv = self.main[seq]
            x = layer_input(x, conv.weight.shape[1], tp, sharded(conv.weight))
            c = _conv(conv, x, 2, 1)
            bn = seq + 1 in SEQ_D_BN
            x = leaky_relu(batch_norm(self.main[seq + 1], c, train=train,
                                      mask=mask) if bn else c)
            if not features:
                continue
            if sharded(conv.weight):
                # the taps hold all channels: the FM loss of one process
                # on every rank of the model group
                x = gather_from_model(x, tp, 1)
                if bn:
                    c = gather_from_model(c, tp, 1)
            # BN's entry aliased to the LeakyReLU's; conv0's to it too
            feats += [c, x, x] if bn else [x, x]
        last = self.main[SEQ_D_CONV[-1]]
        # the projection and the head read the whole last map
        x = layer_input(x, last.weight.shape[1], tp, sharded(last.weight))
        # reshape of the channels_last map: the CHW flatten of the reference
        flat = x.reshape(b, -1).float()
        proj = (F.embedding(labels.long(), self.label_emb.weight)
                * flat).sum(dim=1)
        logits = _conv(last, x, 1, 0).float().reshape(b) + proj
        return (logits, feats) if features else logits
