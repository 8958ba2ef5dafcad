"""PNG writer (role of xgan/native's ``encode_png_batch``), in the
standard library only: 8-bit RGB, filter type 0 on every row, zlib at
level 1. ``zlib.compress`` releases the GIL, so a small thread pool
encodes a batch in parallel.

``decode_png`` reads 8-bit PNGs of every colour type and row filter, as
image libraries write them (the RSNA images and the test fixtures), into
RGB; it stands in for PIL on hosts without an image library.
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


# channels per pixel of each 8-bit colour type: grey, RGB, palette,
# grey+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the PNG row filters of ``raw`` (h, 1 + stride) -> (h, stride).

    None, Sub and Up are whole-row numpy operations; Average and Paeth
    depend on the byte to their left and run as a loop over the row."""
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero prior row
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        prior = out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:
            out[y + 1] = np.cumsum(line.reshape(-1, bpp), axis=0,
                                   dtype=np.uint8).reshape(-1)
        elif kind == 2:
            out[y + 1] = line + prior
        elif kind in (3, 4):
            cur, up = bytearray(line.tobytes()), prior.tobytes()
            for i in range(stride):
                left = cur[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp
                                  else 0)
                cur[i] = (cur[i] + pred) & 0xFF
            out[y + 1] = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG row filter {kind}")
    return out[1:]


def decode_png(path: str) -> np.ndarray:
    """PNG file -> (H, W, 3) uint8, converted to RGB as PIL's
    ``Image.convert("RGB")`` does: grey is repeated over the channels,
    alpha is dropped, a palette is looked up.

    Reads 8-bit grey, RGB, palette, grey+alpha and RGBA images with any
    row filters; raises ``ValueError`` for other bit depths, interlaced
    images and files that are not PNGs."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, palette = len(_SIG), [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, "
                         f"colour type {ctype}); only 8-bit grey, RGB, "
                         "palette, grey+alpha and RGBA are read")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        raw = raw[:h * (1 + w * ch)].reshape(h, 1 + w * ch)
    except (zlib.error, ValueError) as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    img = _unfilter(raw, h, w * ch, ch, path).reshape(h, w, ch)
    if ctype == 3:
        return palette[np.minimum(img[..., 0], len(palette) - 1)]
    if ch <= 2:  # grey (+ alpha)
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
