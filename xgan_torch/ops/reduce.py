"""Validity-weighted reductions (role of xgan/ops/reduce.py).

Padded rows of a wrap-padded final batch carry weight 0, so the mean
covers only the valid rows: the reference's smaller final batch.
"""
from __future__ import annotations

import torch


def weighted_mean(values: torch.Tensor, weights=None) -> torch.Tensor:
    """Mean of ``values`` in f32, or its ``weights``-weighted mean.

    ``max(sum(w), 1e-9)`` keeps an all-zero mask from dividing 0 by 0;
    NaN values in masked rows still propagate through ``sum(values * w)``,
    as in the JAX package."""
    values = values.float()
    if weights is None:
        return values.mean()
    w = weights.float()
    return (values * w).sum() / torch.clamp(w.sum(), min=1e-9)
