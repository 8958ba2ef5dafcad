"""Curriculum batch mixer (role of xgan/data/mixer.py).

Reference semantics: an epoch has len(real) items, and each one is
independently replaced, with probability ``ratio``, by a uniformly drawn
synthetic image with its own (positive) label. Here that is one
``mixed_gather`` over the batch: a (B,) Bernoulli mask picks, row by row,
the real row or a synthetic pick, and only the chosen row is read. The k
folds of a lockstep step (``--parallel-folds``) pass (k, B) indices and
draws, and one fold-batched ``mixed_gather`` builds all k batches.
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
    rows, or (k,B) for k folds; synth_images (N_s,S,S,3) u8, non-empty.
    ``synth_pool``: an optional (P,) int64 row pool, or (k,P) with one
    pool per fold; a synthetic draw then picks from its pool and the
    pool's value indexes the synthetic store. It serves the reference's
    empty-synthetic fallback, with the store aliased to the real store
    and the pool the split's positive rows.

    ``use_synth`` bool and ``synth_pick`` int64 (an index into the pool,
    or the store without one), each of ``real_idx``'s shape, are drawn
    from ``generator`` on the device unless given. ``err`` is
    ``mixed_gather``'s error flag."""
    shape = real_idx.shape
    dev = real_idx.device
    if use_synth is None:
        use_synth = torch.rand(shape, generator=generator, device=dev) < ratio
    n_pool = (synth_pool.shape[-1] if synth_pool is not None
              else synth_images.shape[0])
    if synth_pick is None:
        synth_pick = torch.randint(0, n_pool, shape, generator=generator,
                                   device=dev)
    if synth_pool is None:
        synth_idx = synth_pick
    elif synth_pool.dim() == 1:
        synth_idx = synth_pool[synth_pick]
    else:  # per-fold pools
        synth_idx = torch.gather(synth_pool, 1, synth_pick)
    images = mixed_gather(real_images, synth_images, real_idx, synth_idx,
                          use_synth, err)
    labels = torch.where(use_synth, synth_labels[synth_idx],
                         real_labels[real_idx])
    return images, labels
