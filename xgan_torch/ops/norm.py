"""BatchNorm with torch semantics over the channel axis
(role of xgan/ops/norm.py).

Train mode normalizes with the biased batch variance and updates the
running statistics with momentum 0.1, the running variance from the
unbiased estimate. An optional ``(B,)`` validity mask makes the statistics
those of the valid rows only: the reference DataLoader's smaller final
batch, here a wrap-padded batch of static shape. Masked rows are still
normalized (with the masked statistics); every loss masks them too. A
``(k, B)`` mask is k folds' row weights over k*C fold-major channels
(``ResNet50(folds=k)``): each fold's channels take its own rows.
Statistics and the affine are computed in float32 even when activations
are bf16; the result has the input's dtype.

Across data-parallel ranks (``mesh``, a joined process group) the
statistics are those of the global batch, as GSPMD makes them in the JAX
package: each rank's per-channel ``sum(w*x)``, ``sum(w*x^2)`` and ``n``
are summed over the ranks by one differentiable all-reduce, so the
gradient reaches every rank's rows, and every rank derives the same
running statistics from them.
"""
from __future__ import annotations

import torch

from xgan_torch.parallel.mesh import all_reduce_sum


def batch_norm_train(x, scale, bias, running_mean, running_var, *,
                     dim: int = -1, momentum: float = 0.1,
                     eps: float = 1e-5, mask=None, mesh=None):
    """Train-mode BN over channel axis ``dim`` (the last for NHWC, 1 for
    NCHW). Returns ``(y, new_running_mean, new_running_var)``.

    With ``mask``, ``n = sum(mask) * H * W`` valid elements per channel;
    ``max(n, 1)`` keeps an all-zero mask from dividing by zero. A
    ``(k, B)`` mask weighs the rows of each fold's C = channels / k
    channels with its own row. ``mesh``: the
    :class:`~xgan_torch.parallel.MeshContext` whose ranks share the batch
    (the sums path, with or without a mask)."""
    x32 = x.float()
    dim = dim % x.dim()
    axes = [a for a in range(x.dim()) if a != dim]
    shape = [1] * x.dim()
    shape[dim] = -1
    if mask is None and (mesh is None or not mesh.distributed):
        mean = x32.mean(dim=axes)
        var = x32.square().mean(dim=axes) - mean.square()
        n = torch.tensor(float(x.numel() // x.shape[dim]), device=x.device)
    else:
        w = (torch.ones(x.shape[0], device=x.device) if mask is None
             else mask.float())
        if w.dim() == 2:  # (k, B) -> (B, k*C), fold-major channels
            w = w.t().repeat_interleave(x.shape[dim] // w.shape[0], dim=1)
        else:
            w = w[:, None]
        shape_w = [1] * x.dim()
        shape_w[0], shape_w[dim] = w.shape
        w = w.reshape(shape_w)
        n = w.sum(dim=0).reshape(-1) \
            * float(x.numel() // (x.shape[0] * x.shape[dim]))
        s1 = (x32 * w).sum(dim=axes)
        s2 = (x32.square() * w).sum(dim=axes)
        if mesh is not None and mesh.distributed:
            s1, s2, n = all_reduce_sum(
                torch.stack([s1, s2, n.expand_as(s1)]), mesh)
        denom = torch.clamp(n, min=1.0)
        mean = s1 / denom
        var = s2 / denom - mean.square()
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
