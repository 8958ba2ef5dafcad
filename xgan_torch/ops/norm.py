"""BatchNorm with torch semantics over the channel axis
(role of xgan/ops/norm.py).

Train mode normalizes with the biased batch variance and updates the
running statistics with momentum 0.1, the running variance from the
unbiased estimate. An optional ``(B,)`` validity mask makes the statistics
those of the valid rows only: the reference DataLoader's smaller final
batch, here a wrap-padded batch of static shape. Masked rows are still
normalized (with the masked statistics); every loss masks them too.
Statistics and the affine are computed in float32 even when activations
are bf16; the result has the input's dtype.
"""
from __future__ import annotations

import torch


def batch_norm_train(x, scale, bias, running_mean, running_var, *,
                     dim: int = -1, momentum: float = 0.1,
                     eps: float = 1e-5, mask=None):
    """Train-mode BN over channel axis ``dim`` (the last for NHWC, 1 for
    NCHW). Returns ``(y, new_running_mean, new_running_var)``.

    With ``mask``, ``n = sum(mask) * H * W`` valid elements per channel;
    ``max(n, 1)`` keeps an all-zero mask from dividing by zero."""
    x32 = x.float()
    dim = dim % x.dim()
    axes = [a for a in range(x.dim()) if a != dim]
    shape = [1] * x.dim()
    shape[dim] = -1
    if mask is None:
        mean = x32.mean(dim=axes)
        var = x32.square().mean(dim=axes) - mean.square()
        n = torch.tensor(float(x.numel() // x.shape[dim]), device=x.device)
    else:
        w = mask.float().reshape([-1] + [1] * (x.dim() - 1))
        n = w.sum() * float(x.numel() // (x.shape[0] * x.shape[dim]))
        denom = torch.clamp(n, min=1.0)
        mean = (x32 * w).sum(dim=axes) / denom
        var = (x32.square() * w).sum(dim=axes) / denom - mean.square()
    var = torch.clamp(var, min=0.0)
    unbiased = var * (n / torch.clamp(n - 1, min=1.0))
    new_mean = (1.0 - momentum) * running_mean + momentum * mean
    new_var = (1.0 - momentum) * running_var + momentum * unbiased
    inv = scale.float() / torch.sqrt(var + eps)
    y = (x32 - mean.reshape(shape)) * inv.reshape(shape) \
        + bias.float().reshape(shape)
    return y.to(x.dtype), new_mean, new_var


def batch_norm_infer(x, scale, bias, running_mean, running_var, *,
                     eps: float = 1e-5):
    """Eval-mode BN over the last (channel) axis using running statistics;
    the result has ``x.dtype``."""
    x32 = x.float()
    inv = scale.float() / torch.sqrt(running_var.float() + eps)
    y = (x32 - running_mean.float()) * inv + bias.float()
    return y.to(x.dtype)


def fold_bn(scale, bias, running_mean, running_var, *, eps: float = 1e-5):
    """Eval BN as a per-channel affine ``y = x * scale' + shift'`` in f32:
    ``scale' = scale / sqrt(var + eps)``, ``shift' = bias - mean * scale'``.
    Agrees with :func:`batch_norm_infer` to f32 rounding (the arithmetic
    is reordered), which lets a conv kernel apply BN in its epilogue."""
    s = scale.float() / torch.sqrt(running_var.float() + eps)
    return s, bias.float() - running_mean.float() * s
