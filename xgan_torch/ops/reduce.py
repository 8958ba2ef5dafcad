"""Validity-weighted reductions (role of xgan/ops/reduce.py).

Padded rows of a wrap-padded final batch carry weight 0, so the mean
covers only the valid rows: the reference's smaller final batch. They
live in ops/ so that a model-level loss (the VGG perceptual loss) shares
them with the trainers.
"""
from __future__ import annotations

import torch


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """``t`` in float32, or in its own dtype where that is wider (a
    float64 check runs the f32 arithmetic of the train steps in
    float64)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def weighted_mean(values: torch.Tensor, weights=None,
                  mesh=None) -> torch.Tensor:
    """Mean of ``values`` in f32 (at least), or its ``weights``-weighted
    mean.

    ``max(sum(w), 1e-9)`` keeps an all-zero mask from dividing 0 by 0;
    NaN values in masked rows still propagate through ``sum(values * w)``,
    as in the JAX package.

    ``mesh`` (a joined process group): ``values`` are this rank's rows of
    the global batch, and the result is this rank's share of the global
    mean, its (weighted) sum over the global weight: the shares sum to the
    global mean over the ranks, and so do their gradients."""
    values = at_least_f32(values)
    if mesh is not None and mesh.distributed:
        if weights is None:
            num = values.sum()
            den = torch.full((), float(values.numel()), device=values.device)
        else:
            w = weights.float()
            num, den = (values * w).sum(), w.sum()
        return num / torch.clamp(mesh.all_reduce_(den.detach().clone()),
                                 min=1e-9)
    if weights is None:
        return values.mean()
    w = weights.float()
    return (values * w).sum() / torch.clamp(w.sum(), min=1e-9)


def per_sample_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(B,) mean-squared error per sample in f32, over all other dims."""
    d = a.float() - b.float()
    return d.square().reshape(d.shape[0], -1).mean(dim=1)


def layerwise_mse(feats_a, feats_b, weights=None,
                  mesh=None) -> torch.Tensor:
    """Sum over layers of the (``weights``-weighted) per-layer MSE, in
    layer order: the CGAN feature-matching loss and the VGG perceptual
    loss, torch's ``F.mse_loss`` per layer, summed. ``mesh``: the rows are
    this rank's, and each layer's mean is this rank's share of the global
    one (:func:`weighted_mean`)."""
    total = 0.0
    for a, b in zip(feats_a, feats_b):
        total = total + weighted_mean(per_sample_mse(a, b), weights, mesh)
    return total
