"""DCGAN generator, eval mode (role of xgan/models/dcgan.py:Generator).

z (B, latent) -> ConvT(k=S/32, s1, p0) -> 5 x ConvT(k4, s2, p1) -> tanh,
channels fg*8 -> fg*4 -> fg*2 -> fg -> fg//2 -> C with eval BN + ReLU
between; output NHWC (B, S, S, C) in [-1, 1] like the JAX package.

Parameters live in ``main``, an ``nn.Sequential`` in the reference
layout (ConvT at main.{0,3,6,9,12,15}, BN at main.{1,4,7,10,13}), so a
reference-layout ``.pth`` loads with ``strict=True``. Those modules only
hold parameters; their own ``forward`` is never called. Instead, at load
time (:meth:`Generator.repack`), the ConvT weights are packed for the
kernel in the compute dtype and each eval BN is folded into a per-channel
scale/shift, and :meth:`Generator.forward` runs:

- the first ConvT on the 1x1 input as one matrix product, then eval BN and
  ReLU (XLA computes this outside any Pallas kernel in the JAX package too);
- each middle ConvT+BN+ReLU as one call of the fused kernel
  (``xgan_torch.kernels.convt``);
- the last ConvT as one kernel call with ``act="none"``, then tanh in f32.

Train mode (batch statistics) is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from xgan_torch.kernels.convt import convt4x4s2_fused, pack_convt_weight
from xgan_torch.ops.norm import batch_norm_infer, fold_bn

SEQ_CONVT = (0, 3, 6, 9, 12, 15)
SEQ_BN = (1, 4, 7, 10, 13)


class Generator(nn.Module):
    def __init__(self, latent_dim: int = 100, num_channels: int = 3,
                 feature_maps: int = 64, image_size: int = 224, *,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str | None = None,
                 generator: torch.Generator | None = None):
        """``dtype``: compute dtype of activations (parameters stay f32).
        ``generator``: draws the reference init, N(0, 0.02) conv weights and
        N(1, 0.02) BN scales; it must live on ``device``."""
        super().__init__()
        if image_size % 32:
            raise ValueError(f"image_size must be a multiple of 32, got "
                             f"{image_size}")
        self.latent_dim = latent_dim
        self.s0 = image_size // 32
        self.dtype = dtype
        fg = feature_maps
        widths = [fg * 8, fg * 4, fg * 2, fg, fg // 2]
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
        with torch.no_grad():
            for i in SEQ_CONVT:
                nn.init.normal_(self.main[i].weight, 0.0, 0.02,
                                generator=generator)
            for i in SEQ_BN:
                nn.init.normal_(self.main[i].weight, 1.0, 0.02,
                                generator=generator)
                nn.init.zeros_(self.main[i].bias)
        self.repack()

    @torch.no_grad()
    def repack(self) -> None:
        """Derive the forward's tensors from the parameters: the first
        ConvT as a (latent, S0*S0*C0) matrix whose product is already NHWC,
        the k4s2 weights packed for the kernel (in ``self.dtype``), and
        each eval BN folded into an f32 scale/shift. Runs after init and
        every :meth:`load_state_dict`."""
        w0 = self.main[0].weight
        self.register_buffer(
            "w0_mat", w0.permute(0, 2, 3, 1).reshape(w0.shape[0], -1)
            .to(self.dtype).contiguous(), persistent=False)
        for i, seq in enumerate(SEQ_CONVT[1:]):
            w = self.main[seq].weight
            if i < 4:
                bn = self.main[SEQ_BN[i + 1]]
                scale, shift = fold_bn(bn.weight, bn.bias, bn.running_mean,
                                       bn.running_var, eps=bn.eps)
            else:
                scale = torch.ones(w.shape[1], device=w.device)
                shift = torch.zeros(w.shape[1], device=w.device)
            self.register_buffer(f"wp{i}", pack_convt_weight(w, self.dtype),
                                 persistent=False)
            self.register_buffer(f"scale{i}", scale.contiguous(),
                                 persistent=False)
            self.register_buffer(f"shift{i}", shift.contiguous(),
                                 persistent=False)

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
                convt=convt4x4s2_fused) -> torch.Tensor:
        """z (B, latent) -> images (B, S, S, C) in [-1, 1], float32.

        ``convt``: the function each k4s2 layer calls; the default picks the
        CUDA kernel or, for CPU tensors, its plain version. A check of the
        kernel passes ``convt4x4s2_fused_ref`` to run the plain version on
        the same device."""
        if train:
            raise NotImplementedError(
                "train-mode Generator forward (batch-statistics BN) is not "
                "ported yet: ROADMAP A2/A4")
        b = z.shape[0]
        x = (z.to(self.dtype) @ self.w0_mat).reshape(b, self.s0, self.s0, -1)
        bn = self.main[SEQ_BN[0]]
        x = torch.relu(batch_norm_infer(x, bn.weight, bn.bias,
                                        bn.running_mean, bn.running_var,
                                        eps=bn.eps))
        for i in range(5):
            x = convt(x, getattr(self, f"wp{i}"), getattr(self, f"scale{i}"),
                      getattr(self, f"shift{i}"),
                      act="relu" if i < 4 else "none")
        return torch.tanh(x.float())
