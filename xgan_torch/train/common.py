"""Losses, the optimizer and the gradient-accumulation pieces shared by
the trainers (role of xgan/train/common.py)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from xgan_torch.ops.reduce import weighted_mean


def bce_with_logits(logits: torch.Tensor, target: float | torch.Tensor,
                    mask=None, mesh=None) -> torch.Tensor:
    """Mean binary cross-entropy on logits in f32, a (B,) ``mask`` making
    it the mean over the valid rows: the stable form of the reference's
    Sigmoid + BCELoss. ``target``: one label for every row, or (B,)
    per-sample targets (the CGAN's noisy smoothing). ``mesh``: this
    rank's share of the global mean (``weighted_mean``)."""
    logits = logits.float()
    if not torch.is_tensor(target):
        target = torch.full_like(logits, target)
    per_sample = F.binary_cross_entropy_with_logits(
        logits, target.float(), reduction="none")
    return weighted_mean(per_sample, mask, mesh)


def adam(params, lr: float, beta1: float, beta2: float = 0.999, *,
         capturable: bool = False) -> torch.optim.Adam:
    """torch.optim.Adam with the JAX package's settings (eps 1e-8).
    ``capturable``: keeps the step count and the bias correction on the
    device, so that the update can be captured into a CUDA graph (it
    rounds the bias correction in f32 on the device, where the default
    computes it in double on the host)."""
    return torch.optim.Adam(params, lr=lr, betas=(beta1, beta2), eps=1e-8,
                            capturable=capturable)


def zeroed_grads(params) -> list[torch.Tensor]:
    """Each parameter's ``.grad``, zeroed in place (made when missing), so
    that backward passes accumulate into it and a skipped microbatch
    leaves a zero gradient, not None."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        else:
            p.grad.zero_()
    return [p.grad for p in params]


def guarded_sum(per_sample: torch.Tensor, mask_mb) -> torch.Tensor:
    """Sum over the valid rows in f32 (a select, so masked NaNs drop)."""
    per_sample = per_sample.float()
    if mask_mb is None:
        return per_sample.sum()
    return torch.where(mask_mb > 0, per_sample, 0.0).sum()


def bce_sum(logits: torch.Tensor, target: float | torch.Tensor,
             mask_mb) -> torch.Tensor:
    """The valid-row sum of the BCE on ``logits`` against one label for
    every row or (B,) per-sample targets."""
    logits = logits.float()
    if not torch.is_tensor(target):
        target = torch.full_like(logits, target)
    return guarded_sum(F.binary_cross_entropy_with_logits(
        logits, target.float(), reduction="none"), mask_mb)


def microbatches(mask, b: int, accum: int, mesh=None):
    """The microbatches of a (B,) batch split ``accum`` ways: the weight
    the summed gradients are divided by (the batch's valid rows) and
    ``(rows, mask_mb)`` for each microbatch that holds a valid row
    (``rows`` slices a (B, ...) tensor to it). Reads ``mask`` on the
    host: only a padded tail batch has one, and it never enters a CUDA
    graph.

    ``mesh`` (a joined process group): ``b`` is still the global batch,
    while ``mask`` and the tensors ``rows`` slices hold this rank's rows
    (``MeshContext.local_rows(b, accum)``), its share of each microbatch
    in turn. The weight and which microbatches hold a valid row are the
    global batch's (one all-reduce of the per-microbatch counts), so
    every rank runs the same microbatches and their collectives."""
    if b % accum:
        raise ValueError(f"grad_accum={accum} must divide batch size {b}")
    mb = b // accum
    dp = mesh is not None and mesh.distributed
    n = mesh.micro_rows(mb) if dp else mb

    def rows(j):
        return lambda t: t[j * n:(j + 1) * n]

    if mask is None:
        return float(b), [(rows(j), None) for j in range(accum)]
    valid = mask.reshape(accum, n).float().sum(1)
    if dp:
        valid = mesh.all_reduce_(valid)
    valid = valid.tolist()
    return (max(float(sum(valid)), 1e-9),
            [(rows(j), mask[j * n:(j + 1) * n])
             for j in range(accum) if valid[j] > 0])
