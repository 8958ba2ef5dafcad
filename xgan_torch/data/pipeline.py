"""Device-resident data path (role of xgan/data/pipeline.py).

The uint8 image store lives on the device (:class:`DeviceStore`); each
step gathers its batch there, flips it, normalizes it with the ImageNet
statistics and casts it to the compute dtype. Only the epoch's index
matrix crosses from the host, once per epoch.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def epoch_batches(n: int, batch_size: int, rng: np.random.Generator,
                  *, shuffle: bool = True,
                  indices: np.ndarray | None = None) -> np.ndarray:
    """(num_batches, batch_size) int32 index matrix for one epoch.

    ``indices`` restricts it to a subset (a k-fold split). The tail batch
    is padded by wrapping around the shuffled order, so every batch has
    one shape; num_batches = ceil(n / B), the reference DataLoader's
    count. Same matrix as the JAX package for the same ``rng``."""
    idx = np.arange(n, dtype=np.int32) if indices is None \
        else np.asarray(indices, np.int32)
    n = idx.shape[0]
    if shuffle:
        idx = rng.permutation(idx).astype(np.int32)
    num_batches = (n + batch_size - 1) // batch_size
    padded = np.resize(idx, (num_batches * batch_size,))
    return padded.reshape(num_batches, batch_size)


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    """The ImageNet mean and std on ``device``, copied there once: a
    host-to-device copy inside a step could not be captured into a CUDA
    graph."""
    return (torch.as_tensor(IMAGENET_MEAN, device=device),
            torch.as_tensor(IMAGENET_STD, device=device))


def normalize_images(u8: torch.Tensor, *,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (B,S,S,3) -> ImageNet-normalized images in ``dtype``."""
    mean, std = _imagenet_stats(u8.device)
    x = u8.float() * (1.0 / 255.0)
    return ((x - mean) / std).to(dtype)


def random_flip(u8: torch.Tensor, flip: torch.Tensor | None = None, *,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-sample horizontal flip of (B,S,S,C) images, or (k,B,S,S,C) for
    k folds. ``flip`` is the (B,) or (k,B) bool mask; without one, each
    sample flips with p = 0.5, drawn from ``generator`` on the images'
    device."""
    if flip is None:
        flip = torch.rand(u8.shape[:-3], generator=generator,
                          device=u8.device) < 0.5
    return torch.where(flip[..., None, None, None], u8.flip(-2), u8)


def take_rows(images: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of a store (the single-source gather); (B,) or (k,B)
    indices give (B, ...) or (k, B, ...)."""
    if idx.dim() == 1:
        return images.index_select(0, idx)
    return images.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *images.shape[1:])


def gather_preprocess(images_u8: torch.Tensor, idx: torch.Tensor, *,
                      flip: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The GAN's real batch: rows ``idx`` of the device store, flipped per
    sample (``flip``, else drawn from ``generator``), ImageNet-normalized,
    in ``dtype``. The reference trains its GAN on ImageNet-normalized
    reals though G's tanh spans [-1, 1]; the port keeps that quirk."""
    batch = random_flip(take_rows(images_u8, idx), flip, generator=generator)
    return normalize_images(batch, dtype=dtype)


def minmax_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Global min-max rescale of a whole sheet to uint8, rounded half to
    even: the reference's sample-sheet transform
    (``save_image(normalize=True)``); exports use :func:`tanh_to_u8`."""
    x = x.float()
    lo, hi = x.min(), x.max()
    y = (x - lo) / torch.clamp(hi - lo, min=1e-12)
    return torch.round(y * 255.0).to(torch.uint8)


def tanh_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Generator output in [-1, 1] -> uint8 via ``x*0.5+0.5``, clipped,
    times 255, rounded half to even: the reference's synthetic-image export
    transform, computed on ``x``'s device."""
    y = torch.clamp(x.float() * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(y * 255.0).to(torch.uint8)


class DeviceStore:
    """An ImageStore copied to the device: ``images`` (N,S,S,3) uint8 and
    ``labels`` (N,) int64 there, ``labels_host`` (N,) int32 on the host.

    The 26,684-image RSNA train store is 4.0 GB at 224 px, well inside
    one H100's 80 GB. (The JAX package's sharded and multi-host
    placements are not ported.)"""

    def __init__(self, store, device: torch.device | str):
        self.labels_host = np.asarray(store.labels, np.int32)
        # np.array copies: a cached store is a read-only memory map
        self.images = torch.from_numpy(np.array(store.images)).to(device)
        self.labels = torch.from_numpy(
            self.labels_host.astype(np.int64)).to(device)

    def __len__(self) -> int:
        return self.images.shape[0]
