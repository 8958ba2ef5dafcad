"""DCGAN generator and discriminator (role of xgan/models/dcgan.py).

Generator: z (B, latent) -> ConvT(k=S/32, s1, p0) -> 5 x ConvT(k4, s2, p1)
-> tanh, channels fg*8 -> fg*4 -> fg*2 -> fg -> fg//2 -> C with BN + ReLU
between (``widths``: another ladder, as the WGAN-GP generator's one width
up); output NHWC (B, S, S, C) in [-1, 1] like the JAX package.

Discriminator: NHWC (B, S, S, C) -> Conv(k4, s2, p1) x 5, widths fd//2 ->
fd -> fd*2 -> fd*4 -> fd*8, BN on all but the first, LeakyReLU 0.2 ->
Conv(k=S/32, valid) -> f32 logits (B,) (no sigmoid: the losses take
logits).

Parameters live in ``main``, an ``nn.Sequential`` in the reference
layout, so a reference-layout ``.pth`` loads with ``strict=True``:
Generator ConvT at main.{0,3,6,9,12,15}, BN at main.{1,4,7,10,13};
Discriminator conv at main.{0,2,5,8,11,14}, BN at main.{3,6,9,12}. Those
modules only hold parameters; their own ``forward`` is never called.
Parameters are f32 and activations run in the compute ``dtype``.

The generator has two forwards:

- :meth:`Generator.forward`, eval mode under ``no_grad``, on tensors that
  :meth:`Generator.repack` derives from the parameters at load time: the
  first ConvT as one matrix product, then eval BN and ReLU; each middle
  ConvT+BN+ReLU as one call of the fused kernel (eval BN folded into its
  epilogue); the last ConvT as one kernel call with ``act="none"``, then
  tanh in f32. After the parameters change (a train step), call
  ``repack()`` before it.
- :meth:`Generator.forward_train`, differentiable, from the live
  parameters: the first ConvT as a matrix product, each k4s2 ConvT as
  ``convt4x4s2_train`` (the kernel forward, cuDNN backward), each BN in
  train mode with batch statistics (running statistics advance once per
  call), tanh in f32.

Under tensor parallelism (:func:`xgan_torch.parallel.tp.shard_over_model`
sets ``tp``, the model group, and slices the wide leaves) each wide layer
is column-parallel, both forwards of G and D's: a rank computes its slice
of the layer's output channels from all of its input channels, gathered
where the previous layer left a slice (:func:`~xgan_torch.parallel.tp.
layer_input`); BN and the activation act on the slice. G's first ConvT
is packed from its sliced parameter, so its matrix's columns are this
rank's channels at every pixel; each sliced k4s2 layer runs the kernel on
its slice of Cout. D gathers before the next layer that needs all
channels and before its valid head.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from xgan_torch.kernels.convt import (convt4x4s2_fused, convt4x4s2_train,
                                      pack_convt_weight)
from xgan_torch.models.layers import batch_norm, gan_init_, leaky_relu
from xgan_torch.ops.conv import conv2d_double_backward
from xgan_torch.ops.norm import batch_norm_infer, fold_bn
from xgan_torch.parallel.tp import copy_to_model, layer_input, sharded

SEQ_CONVT = (0, 3, 6, 9, 12, 15)
SEQ_BN = (1, 4, 7, 10, 13)
SEQ_D_CONV = (0, 2, 5, 8, 11, 14)
SEQ_D_BN = (3, 6, 9, 12)
# the eval forward's tensors, which ``Generator.packed`` derives
PACKED = ("w0_mat",) + tuple(f"{k}{i}" for i in range(5)
                             for k in ("wp", "scale", "shift"))


def _check_size(image_size: int) -> None:
    if image_size % 32:
        raise ValueError(f"image_size must be a multiple of 32, got "
                         f"{image_size}")


class Generator(nn.Module):
    def __init__(self, latent_dim: int = 100, num_channels: int = 3,
                 feature_maps: int = 64, image_size: int = 224, *,
                 widths: Sequence[int] | None = None,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """``widths``: the output channels of the first five ConvTs
        (default the DCGAN ladder fg*8 ... fg//2). ``dtype``: compute
        dtype of activations (parameters stay f32). ``generator``: draws
        the reference init, N(0, 0.02) conv weights and N(1, 0.02) BN
        scales; it must live on ``device``."""
        super().__init__()
        _check_size(image_size)
        self.latent_dim = latent_dim
        self.s0 = image_size // 32
        self.dtype = dtype
        fg = feature_maps
        if widths is None:
            widths = [fg * 8, fg * 4, fg * 2, fg, fg // 2]
        if len(widths) != 5:
            raise ValueError(f"widths must name 5 layers, got {widths}")
        layers = [nn.ConvTranspose2d(latent_dim, widths[0], self.s0, 1, 0,
                                     bias=False, device=device),
                  nn.BatchNorm2d(widths[0], device=device), nn.ReLU(True)]
        for cin, cout in zip(widths, widths[1:]):
            layers += [nn.ConvTranspose2d(cin, cout, 4, 2, 1, bias=False,
                                          device=device),
                       nn.BatchNorm2d(cout, device=device), nn.ReLU(True)]
        layers += [nn.ConvTranspose2d(widths[-1], num_channels, 4, 2, 1,
                                      bias=False, device=device), nn.Tanh()]
        self.main = nn.Sequential(*layers)
        gan_init_(self.main, generator)
        self.repack()

    @torch.no_grad()
    def repack(self) -> None:
        """Derive the eval forward's tensors from the parameters
        (:meth:`packed`) and keep them as buffers. Runs after init and
        every :meth:`load_state_dict`; a trainer calls it before each eval
        render."""
        for name, t in self.packed().items():
            self.register_buffer(name, t, persistent=False)

    def packed(self, p=None) -> dict:
        """The eval forward's tensors from ``p`` ({state-dict name:
        tensor}, default the module's own): the first ConvT as a (latent,
        S0*S0*C0) matrix whose product is already NHWC, the k4s2 weights
        packed for the kernel (in ``self.dtype``), and each eval BN folded
        into an f32 scale/shift. An exported int8 program calls it on its
        dequantized weights on every call."""
        if p is None:
            p = dict(self.named_parameters())
            p.update(self.named_buffers())
        # a copy: at S0 = 1 the reshape is a view of the parameter
        out = {"w0_mat": self._w0_mat(p["main.0.weight"]).clone()}
        for i, seq in enumerate(SEQ_CONVT[1:]):
            w = p[f"main.{seq}.weight"]
            if i < 4:
                bn = f"main.{SEQ_BN[i + 1]}"
                scale, shift = fold_bn(
                    p[f"{bn}.weight"], p[f"{bn}.bias"],
                    p[f"{bn}.running_mean"], p[f"{bn}.running_var"],
                    eps=self.main[SEQ_BN[i + 1]].eps)
            else:
                scale = torch.ones(w.shape[1], device=w.device)
                shift = torch.zeros(w.shape[1], device=w.device)
            out[f"wp{i}"] = pack_convt_weight(w, self.dtype)
            out[f"scale{i}"] = scale.contiguous()
            out[f"shift{i}"] = shift.contiguous()
        return out

    def _w0_mat(self, w0: torch.Tensor | None = None) -> torch.Tensor:
        """The first ConvT (``w0``, default the parameter) on the 1x1
        input as a (latent, S0*S0*C0) matrix in ``self.dtype``,
        differentiable in the weight."""
        if w0 is None:
            w0 = self.main[0].weight
        return w0.permute(0, 2, 3, 1).reshape(w0.shape[0], -1) \
            .to(self.dtype).contiguous()

    def set_compute_dtype(self, dtype: torch.dtype) -> None:
        """Switch the activation dtype, repacking the weights for it."""
        if dtype != self.dtype:
            self.dtype = dtype
            self.repack()

    def load_state_dict(self, state_dict, strict: bool = True,
                        assign: bool = False):
        result = super().load_state_dict(state_dict, strict=strict,
                                         assign=assign)
        self.repack()
        return result

    @torch.no_grad()
    def forward(self, z: torch.Tensor, *, train: bool = False,
                convt=convt4x4s2_fused, packed: dict | None = None
                ) -> torch.Tensor:
        """z (B, latent) -> images (B, S, S, C) in [-1, 1], float32.

        ``convt``: the function each k4s2 layer calls; the default picks the
        CUDA kernel or, for CPU tensors, its plain version. A check of the
        kernel passes ``convt4x4s2_fused_ref`` to run the plain version on
        the same device. ``packed``: :meth:`packed`'s tensors in place of
        the buffers :meth:`repack` keeps."""
        if train:
            raise NotImplementedError(
                "Generator.forward is the eval path (no autograd); train "
                "mode is Generator.forward_train (ROADMAP A2)")
        t = packed if packed is not None else {
            name: getattr(self, name) for name in PACKED}
        b = z.shape[0]
        x = (z.to(self.dtype) @ t["w0_mat"]).reshape(b, self.s0, self.s0, -1)
        bn = self.main[SEQ_BN[0]]
        x = torch.relu(batch_norm_infer(x, bn.weight, bn.bias,
                                        bn.running_mean, bn.running_var,
                                        eps=bn.eps))
        for i, seq in enumerate(SEQ_CONVT[1:]):
            x = self._input(x, seq)
            x = convt(x, t[f"wp{i}"], t[f"scale{i}"], t[f"shift{i}"],
                      act="relu" if i < 4 else "none")
        return torch.tanh(x.float())

    def _input(self, x: torch.Tensor, seq: int) -> torch.Tensor:
        """``x`` (NHWC) as the input of the ConvT at ``main[seq]``: all
        channels, and column-parallel when its weight is a slice (``x``
        itself without tensor parallelism)."""
        w = self.main[seq].weight
        return layer_input(x, w.shape[0], getattr(self, "tp", None),
                           sharded(w), dim=-1)

    def forward_train(self, z: torch.Tensor, mask=None, *,
                      convt=convt4x4s2_fused,
                      update_stats: bool = True) -> torch.Tensor:
        """Train-mode forward, differentiable in the parameters: z (B,
        latent) -> (B, S, S, C) f32 in [-1, 1]. ``mask``: (B,) validity
        weights of a padded tail batch for the BN statistics (outputs at
        masked rows are garbage by contract). ``convt`` as in
        :meth:`forward`. ``update_stats=False`` leaves the BN running
        statistics where they are (a recompute of a forward that already
        advanced them)."""
        b = z.shape[0]
        if sharded(self.main[0].weight):
            z = copy_to_model(z, self.tp)
        x = (z.to(self.dtype) @ self._w0_mat()).reshape(b, self.s0, self.s0,
                                                        -1)
        x = torch.relu(batch_norm(self.main[SEQ_BN[0]], x, train=True,
                                  mask=mask, dim=-1,
                                  update_stats=update_stats))
        for i, seq in enumerate(SEQ_CONVT[1:]):
            x = convt4x4s2_train(self._input(x, seq), self.main[seq].weight,
                                 convt)
            if i < 4:
                x = torch.relu(batch_norm(self.main[SEQ_BN[i + 1]], x,
                                          train=True, mask=mask, dim=-1,
                                          update_stats=update_stats))
        return torch.tanh(x.float())


class Discriminator(nn.Module):
    def __init__(self, num_channels: int = 3, feature_maps: int = 64,
                 image_size: int = 224, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """``dtype`` and ``generator`` as for :class:`Generator`."""
        super().__init__()
        _check_size(image_size)
        self.dtype = dtype
        fd = feature_maps
        widths = [fd // 2, fd, fd * 2, fd * 4, fd * 8]
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

    def forward(self, x: torch.Tensor, *, train: bool,
                mask=None) -> torch.Tensor:
        """x (B, S, S, C) NHWC -> f32 logits (B,). ``mask``: (B,) validity
        weights for train-mode BN statistics."""
        x = conv_ladder(self.main, SEQ_D_CONV, SEQ_D_BN, x, self.dtype,
                        train=train, mask=mask, tp=getattr(self, "tp", None))
        return x.float().reshape(x.shape[0])


def conv_ladder(main: nn.Sequential, seq_conv, seq_bn, x: torch.Tensor,
                dtype: torch.dtype, *, train: bool, mask=None,
                tp=None, double_backward: bool = False) -> torch.Tensor:
    """The convolutions of a reference-layout discriminator ``main`` (conv
    at ``seq_conv``, BN right after the convs that have one at ``seq_bn``):
    NHWC ``x`` -> the last conv's NCHW output in ``dtype``. Each conv but
    the last is k4 s2 p1, then BN where there is one, then LeakyReLU 0.2;
    the last is valid with stride 1. The convolutions are cuDNN's, on a
    channels_last NCHW view in ``dtype`` (the JAX package leaves them to
    XLA too). ``tp``: the model group of a tensor-parallel ``main``
    (column-parallel wide convs; see the module docstring); its
    collectives stay outside the convs. ``double_backward``: the forward
    whose input gradient is differentiated again (the WGAN-GP penalty's
    on x̂), where each conv is
    :func:`~xgan_torch.ops.conv.conv2d_double_backward` (its input
    gradient a transposed convolution on the graph); every other forward,
    the DCGAN discriminator's included, is plain ``F.conv2d``,
    differentiated once."""
    conv = conv2d_double_backward if double_backward else F.conv2d
    x = x.to(dtype).permute(0, 3, 1, 2)
    for seq in seq_conv:
        w = main[seq].weight
        x = layer_input(x, w.shape[1], tp, sharded(w))
        if seq == seq_conv[-1]:
            return conv(x, w.to(x.dtype))
        x = conv(x, w.to(x.dtype), stride=2, padding=1)
        if seq + 1 in seq_bn:
            x = batch_norm(main[seq + 1], x, train=train, mask=mask)
        x = leaky_relu(x)
