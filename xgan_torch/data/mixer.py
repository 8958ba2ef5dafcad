"""Curriculum batch mixer (role of xgan/data/mixer.py).

Reference semantics: an epoch has len(real) items, and each one is
independently replaced, with probability ``ratio``, by a uniformly drawn
synthetic image with its own (positive) label. Here that is one
``mixed_gather`` over the batch: a (B,) Bernoulli mask picks, row by row,
the real row or a synthetic pick, and only the chosen row is read.
"""
from __future__ import annotations

import torch

from xgan_torch.kernels.gather import mixed_gather


def mix_batch(real_images: torch.Tensor, real_labels: torch.Tensor,
              real_idx: torch.Tensor, synth_images: torch.Tensor,
              synth_labels: torch.Tensor, ratio: float, *,
              synth_pool: torch.Tensor | None = None,
              generator: torch.Generator | None = None,
              use_synth: torch.Tensor | None = None,
              synth_pick: torch.Tensor | None = None,
              err: torch.Tensor | None = None):
    """Returns the mixed uint8 batch and its labels.

    real_images (N_r,S,S,3) u8 with real_idx (B,) int64, this batch's
    rows; synth_images (N_s,S,S,3) u8, non-empty. ``synth_pool``: an
    optional (P,) int64 row pool; a synthetic draw then picks from the
    pool and the pool's value indexes the synthetic store. It serves the
    reference's empty-synthetic fallback, with the store aliased to the
    real store and the pool the split's positive rows.

    ``use_synth`` (B,) bool and ``synth_pick`` (B,) int64 (an index into
    the pool, or the store without one) are drawn from ``generator`` on
    the device unless given. ``err`` is ``mixed_gather``'s error flag."""
    b = real_idx.shape[0]
    dev = real_idx.device
    if use_synth is None:
        use_synth = torch.rand(b, generator=generator, device=dev) < ratio
    n_pool = (synth_pool.shape[0] if synth_pool is not None
              else synth_images.shape[0])
    if synth_pick is None:
        synth_pick = torch.randint(0, n_pool, (b,), generator=generator,
                                   device=dev)
    synth_idx = synth_pick if synth_pool is None else synth_pool[synth_pick]
    images = mixed_gather(real_images, synth_images, real_idx, synth_idx,
                          use_synth, err)
    labels = torch.where(use_synth, synth_labels[synth_idx],
                         real_labels[real_idx])
    return images, labels
