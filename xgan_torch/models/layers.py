"""Shared pieces of the port's models (role of xgan/models/layers.py).

The GAN init is the reference's ``weights_init`` contract: N(0, 0.02)
conv weights, N(1, 0.02) BatchNorm scales and zero BatchNorm biases,
drawn from a caller's ``torch.Generator`` (``xgan/models/layers.py:39-50``).

:func:`batch_norm` applies an ``nn.BatchNorm2d``'s parameters and running
statistics in the JAX package's dtype policy: statistics and the affine in
f32, the result in the input's dtype. In train mode it uses batch
statistics and writes the new running statistics back into the module's
buffers (momentum 0.1, unbiased variance); a (B,) validity ``mask``
restricts the statistics to the valid rows of a padded tail batch
(``xgan_torch.ops.norm.batch_norm_train``). Without a mask, train BN is
``F.batch_norm``, which has the same semantics. :func:`sync_batch_norm`
makes a model's train-mode statistics those of the batch its data-parallel
ranks share; such a BN always takes the sums path (``F.batch_norm`` sees
this rank's rows only). Under tensor parallelism a BN of a sliced width
holds this rank's channels (scale, shift and running statistics): BN is
per channel, so it is exact on the slice, its moments reduced over the
data group it is tied to.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from xgan_torch.ops.norm import batch_norm_train


@torch.no_grad()
def gan_init_(modules, generator: torch.Generator | None = None) -> None:
    """The reference GAN init of every conv and transposed conv, then of
    every BN, in ``modules``, from ``generator`` (on their device)."""
    modules = list(modules)
    for m in modules:
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
    for m in modules:
        if isinstance(m, nn.BatchNorm2d):
            nn.init.normal_(m.weight, 1.0, 0.02, generator=generator)
            nn.init.zeros_(m.bias)


def sync_batch_norm(model: nn.Module, mesh) -> None:
    """Tie every ``nn.BatchNorm2d`` of ``model`` to ``mesh`` (a
    :class:`~xgan_torch.parallel.MeshContext`, or None to untie them):
    :func:`batch_norm` then reduces its train-mode statistics over the
    ranks. The counterpart of ``nn.SyncBatchNorm.convert_sync_batchnorm``
    for the port's functional BN."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.mesh = mesh


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor, *, train: bool,
               mask=None, dim: int = 1,
               update_stats: bool = True) -> torch.Tensor:
    """BN over channel axis ``dim`` (1 for NCHW, -1 for NHWC) with the
    parameters and running statistics of ``bn``; see the module
    docstring. ``update_stats=False``: train mode that leaves the running
    statistics as they are (the same arithmetic, its update discarded)."""
    mesh = getattr(bn, "mesh", None)
    if train and (mask is not None
                  or (mesh is not None and mesh.distributed)):
        y, new_mean, new_var = batch_norm_train(
            x, bn.weight, bn.bias, bn.running_mean, bn.running_var, dim=dim,
            momentum=bn.momentum, eps=bn.eps, mask=mask, mesh=mesh)
        if update_stats:
            with torch.no_grad():
                bn.running_mean.copy_(new_mean)
                bn.running_var.copy_(new_var)
        return y
    mean, var = bn.running_mean, bn.running_var
    if train and not update_stats:  # scratch copies take the update
        mean, var = mean.clone(), var.clone()
    y = F.batch_norm(x.movedim(dim, 1), mean, var, bn.weight, bn.bias,
                     training=train, momentum=bn.momentum, eps=bn.eps)
    return y.movedim(1, dim)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, slope)
