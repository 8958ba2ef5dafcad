"""Losses and the optimizer shared by the GAN trainers
(role of xgan/train/common.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from xgan_torch.ops.reduce import weighted_mean


def bce_with_logits(logits: torch.Tensor, target: float | torch.Tensor,
                    mask=None) -> torch.Tensor:
    """Mean binary cross-entropy on logits in f32, a (B,) ``mask`` making
    it the mean over the valid rows: the stable form of the reference's
    Sigmoid + BCELoss. ``target``: one label for every row, or (B,)
    per-sample targets (the CGAN's noisy smoothing)."""
    logits = logits.float()
    if not torch.is_tensor(target):
        target = torch.full_like(logits, target)
    per_sample = F.binary_cross_entropy_with_logits(
        logits, target.float(), reduction="none")
    return weighted_mean(per_sample, mask)


def adam(params, lr: float, beta1: float, beta2: float = 0.999, *,
         capturable: bool = False) -> torch.optim.Adam:
    """torch.optim.Adam with the JAX package's settings (eps 1e-8).
    ``capturable``: keeps the step count and the bias correction on the
    device, so that the update can be captured into a CUDA graph (it
    rounds the bias correction in f32 on the device, where the default
    computes it in double on the host)."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                            capturable=capturable)
