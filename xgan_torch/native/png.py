"""PNG writer (role of xgan/native's ``encode_png_batch``), in the
standard library only: 8-bit RGB, filter type 0 on every row, zlib at
level 1. ``zlib.compress`` releases the GIL, so a small thread pool
encodes a batch in parallel.

``decode_png`` reads back what ``encode_png`` writes (8-bit RGB, filter
0, no interlace) and rejects anything else; it exists to check outputs on
hosts without an image library.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, compress_level: int = 1) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes."""
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"expected (H, W, 3) uint8, got {image.shape} "
                         f"{image.dtype}")
    h, w, _ = image.shape
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # leading 0 = filter None
    raw[:, 1:] = image.reshape(h, 3 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), compress_level))
            + _chunk(b"IEND", b""))


def _write(image: np.ndarray, path: str, compress_level: int) -> bool:
    data = encode_png(image, compress_level)
    try:
        with open(path, "wb") as f:
            f.write(data)
    except OSError:
        return False
    return True


def encode_png_batch(images: np.ndarray, paths: list[str],
                     compress_level: int = 1,
                     n_threads: int | None = None) -> int:
    """Write (B, H, W, 3) uint8 images to PNG files; returns the number of
    files that could not be written."""
    if images.ndim != 4 or images.shape[-1] != 3:
        raise ValueError(f"expected (B, H, W, 3), got {images.shape}")
    if images.shape[0] != len(paths):
        raise ValueError(f"{images.shape[0]} images for {len(paths)} paths")
    images = np.ascontiguousarray(images, np.uint8)
    threads = n_threads or min(8, os.cpu_count() or 1)
    with ThreadPoolExecutor(max_workers=threads) as pool:
        ok = list(pool.map(_write, images, paths,
                           [compress_level] * len(paths)))
    return ok.count(False)


def decode_png(path: str) -> np.ndarray:
    """PNG file written by :func:`encode_png` -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = len(_SIG), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB non-interlaced PNG")
    w, h = hdr[0], hdr[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: rows use PNG filters other than None")
    return raw[:, 1:].reshape(h, w, 3).copy()
