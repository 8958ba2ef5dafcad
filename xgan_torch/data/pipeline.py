"""Device-resident data path (role of xgan/data/pipeline.py).

The uint8 image store lives on the device (:class:`DeviceStore`); each
step gathers its batch there, flips it, normalizes it with the ImageNet
statistics and casts it to the compute dtype. Only the epoch's index
matrix crosses from the host, once per epoch.

Across data-parallel ranks every rank holds the epoch's global index
matrix and draws the global batch's randomness from the same seed; a
step then gathers its own rows (``rows``, :meth:`MeshContext.local_rows
<xgan_torch.parallel.MeshContext.local_rows>`). A store is replicated on
every rank, or, with ``--shard-store``, split over the ranks; its
``take`` then assembles rows by one all-reduce (:func:`sharded_take`).
Under ``--model-parallel`` the ranks are the data group's: the ranks of
one model group hold the same block and gather the same rows.
"""
from __future__ import annotations

import numpy as np
import torch

from xgan_torch.utils.cache import per_device

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


@per_device
def _imagenet_stats(device: torch.device):
    """The ImageNet mean and std on ``device``, copied there once."""
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


def take_rows(images: torch.Tensor, idx: torch.Tensor,
              rows: slice = slice(None)) -> torch.Tensor:
    """Rows ``idx`` of a store (the single-source gather); (B,) or (k,B)
    indices give (B, ...) or (k, B, ...). ``rows``: the part of the batch
    to gather (a rank's rows), sliced along its last axis."""
    idx = idx[..., rows]
    if idx.dim() == 1:
        return images.index_select(0, idx)
    return images.index_select(0, idx.reshape(-1)).reshape(
        *idx.shape, *images.shape[1:])


def sharded_take(mesh, shard_rows: int):
    """The row gather of a store split over ``mesh``'s ranks, rank r
    holding rows ``[r*shard_rows, (r+1)*shard_rows)`` (counterpart of
    ``make_sharded_take``). ``take(images, idx, rows)`` takes the same
    (B,) global ``idx`` on every rank (it is a collective): each rank
    gathers its own hits in bf16, where every u8 value is exact, zeroes
    the misses, and one SUM all-reduce assembles the batch, exactly one
    rank contributing to each row; then ``rows`` of it, as u8."""

    def take(images: torch.Tensor, idx: torch.Tensor,
             rows: slice = slice(None)) -> torch.Tensor:
        rel = idx - mesh.rank * shard_rows
        hit = (rel >= 0) & (rel < shard_rows)
        got = images.index_select(0, rel.clamp(0, shard_rows - 1))
        got = torch.where(hit[:, None, None, None], got.to(torch.bfloat16),
                          0.0)
        return mesh.all_reduce_(got)[rows].to(torch.uint8)

    return take


def gather_preprocess(images_u8: torch.Tensor, idx: torch.Tensor, *,
                      flip: torch.Tensor | None = None,
                      generator: torch.Generator | None = None,
                      dtype: torch.dtype = torch.float32,
                      take=take_rows,
                      rows: slice = slice(None)) -> torch.Tensor:
    """The GAN's real batch: rows ``idx`` of the device store, flipped per
    sample (``flip``, else drawn from ``generator``), ImageNet-normalized,
    in ``dtype``. The reference trains its GAN on ImageNet-normalized
    reals though G's tanh spans [-1, 1]; the port keeps that quirk.

    ``take``: the store's gather (a :class:`DeviceStore`'s ``take``);
    ``rows``: the part of the batch this rank keeps. The flip is drawn for
    the whole batch ``idx``, then sliced."""
    if flip is None:
        flip = torch.rand(idx.shape, generator=generator,
                          device=images_u8.device) < 0.5
    batch = random_flip(take(images_u8, idx, rows), flip[..., rows])
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
    ``labels`` (N,) int64 there, ``labels_host`` (N,) int32 on the host;
    ``take(images, idx, rows)`` gathers rows of a batch (:func:`take_rows`).

    The 26,684-image RSNA train store is 4.0 GB at 224 px, well inside
    one H100's 80 GB, so by default every rank holds all of it.
    ``shard=True`` with a ``mesh`` of several ranks (``--shard-store``):
    the images are padded to P, a multiple of the ranks, and rank r holds
    rows ``[r*P/N, (r+1)*P/N)``; ``take`` becomes :func:`sharded_take`.
    ``len()`` stays the logical count (no index reaches a pad row), and
    the labels stay replicated (8 bytes a row). One process per rank
    holds the whole decoded store on the host and copies its own block to
    its device (the JAX package's multi-host placement does the same)."""

    def __init__(self, store, device: torch.device | str, mesh=None,
                 shard: bool = False):
        self.labels_host = np.asarray(store.labels, np.int32)
        self._n = int(store.images.shape[0])
        self.take = take_rows
        imgs = store.images
        if shard and mesh is not None and mesh.world > 1:
            block = -(-self._n // mesh.world)
            lo = min(mesh.rank * block, self._n)
            hi = min(lo + block, self._n)
            local = np.zeros((block,) + imgs.shape[1:], np.uint8)
            local[:hi - lo] = imgs[lo:hi]
            imgs = local
            self.take = sharded_take(mesh, block)
        # np.array copies: a cached store is a read-only memory map
        self.images = torch.from_numpy(np.array(imgs)).to(device)
        self.labels = torch.from_numpy(
            self.labels_host.astype(np.int64)).to(device)

    @property
    def sharded(self) -> bool:
        return self.take is not take_rows

    def __len__(self) -> int:
        return self._n
