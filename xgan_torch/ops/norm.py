"""Eval-mode BatchNorm with torch semantics (role of xgan/ops/norm.py).

Statistics and the affine are computed in float32 even when activations
are bf16. Train-mode BN is not ported yet (ROADMAP A1).
"""
from __future__ import annotations

import torch


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
