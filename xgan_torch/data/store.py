"""Decode-once image store: PNG -> resized uint8 array, cached on disk
(role of xgan/data/store.py).

Every image is decoded once into a uint8 ``(N, S, S, 3)`` array, saved
as ``.npy`` under the cache directory (keyed by the paths, their mtimes
and the size, as in the JAX package) and memory-mapped on later runs;
the training loop then works on a copy on the device.

The resize stands in for PIL's ``Image.BILINEAR``, which widens its
triangle filter when it shrinks: ``F.interpolate(mode="bilinear",
antialias=True)`` on the f32 image, rounded to u8. It lands within one u8
level of PIL. A missing or corrupt file becomes a black image with a
warning, like the reference. The decode follows libpng's conversions, as
the JAX package's native store does (``xgan_torch.native.png``); with
``compiled=True`` (every card run) it undoes the row filters with the
compiled host op, and a failed build of that op raises.
"""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from xgan_torch.native.png import decode_png


def resize_u8(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) uint8, antialiased bilinear."""
    if img.shape[:2] == (size, size):
        return img
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(x.float(), size=(size, size), mode="bilinear",
                      antialias=True, align_corners=False)
    y = torch.round(y[0].permute(1, 2, 0)).clamp_(0, 255)
    return y.to(torch.uint8).numpy()


def _decode_resize(path: str, size: int, compiled: bool) -> np.ndarray:
    try:
        img = decode_png(path, compiled=compiled)
    except (OSError, ValueError) as e:  # missing or corrupt -> black
        print(f"Warning: could not load image {path}: {e}")
        return np.zeros((size, size, 3), np.uint8)
    return resize_u8(img, size)


def _decode_all(paths: list[str], size: int, workers: int,
                compiled: bool) -> np.ndarray:
    images = np.empty((len(paths), size, size, 3), np.uint8)

    def one(i):
        images[i] = _decode_resize(paths[i], size, compiled)

    with ThreadPoolExecutor(max_workers=max(1, workers)) as pool:
        for n, _ in enumerate(pool.map(one, range(len(paths))), 1):
            if n % 2000 == 0:
                print(f"  decoded {n}/{len(paths)} images")
    return images


def _cache_key(paths, size: int) -> str:
    h = hashlib.sha256()
    h.update(str(size).encode())
    for p in paths:
        h.update(p.encode())
        try:
            h.update(str(os.path.getmtime(p)).encode())
        except OSError:
            h.update(b"missing")
    return h.hexdigest()[:16]


@dataclass
class ImageStore:
    """uint8 (N, S, S, 3) image array + int32 labels, host-side."""
    images: np.ndarray
    labels: np.ndarray
    size: int

    def __len__(self) -> int:
        return self.images.shape[0]

    @staticmethod
    def build(paths: list[str], labels, size: int,
              cache_dir: str | None = None, name: str = "store",
              workers: int = 4, compiled: bool = False) -> "ImageStore":
        """Decode (or load cached) images at the given square size;
        ``workers`` threads decode and resize; ``compiled``: undo the PNG
        row filters with the compiled op (a card run)."""
        labels = np.asarray(labels, np.int32)
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            key = _cache_key(paths, size)
            npy = os.path.join(cache_dir, f"{name}_{key}.npy")
            meta = os.path.join(cache_dir, f"{name}_{key}.json")
            if os.path.exists(npy) and os.path.exists(meta):
                return ImageStore(np.load(npy, mmap_mode="r"), labels, size)

        images = _decode_all(paths, size, workers, compiled)

        if cache_dir:
            # temp file + atomic rename: another process must never map a
            # half-written .npy
            tmp = f"{npy[:-4]}.tmp{os.getpid()}.npy"
            np.save(tmp, images)
            os.replace(tmp, npy)
            tmp_meta = f"{meta}.tmp.{os.getpid()}"
            with open(tmp_meta, "w") as f:
                json.dump({"n": len(paths), "size": size}, f)
            os.replace(tmp_meta, meta)
            images = np.load(npy, mmap_mode="r")
        return ImageStore(images=images, labels=labels, size=size)


def decode_folder_store(folder: str, size: int, label: int = 1,
                        cache_dir: str | None = None,
                        name: str = "synthetic",
                        workers: int = 4,
                        compiled: bool = False) -> ImageStore:
    """Store over every ``*.png`` in a folder, all with ``label`` (the
    reference's synthetic images are all positive)."""
    files = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                   if f.endswith(".png"))
    print(f"Found {len(files)} synthetic images in {folder}")
    labels = np.full((len(files),), label, np.int32)
    return ImageStore.build(files, labels, size, cache_dir=cache_dir,
                            name=name, workers=workers, compiled=compiled)
