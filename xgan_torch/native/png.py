"""PNG codec (role of xgan/native's ``encode_png_batch`` and
``decode_png_batch``).

The writer is standard library only: 8-bit RGB, filter type 0 on every
row, zlib at level 1. ``zlib.compress`` releases the GIL, so a small
thread pool encodes a batch in parallel.

``decode_png`` reads every PNG the format allows (each colour type at each
of its bit depths, Adam7-interlaced or not, any row filters) into 8-bit
RGB, as libpng does for the JAX package's store
(``png_set_strip_16``, grey 1/2/4 -> 8 expansion, palette lookup, grey
repeated, alpha and ``tRNS`` dropped). One rule differs between the JAX
package's two readers, and ``grey16`` picks it: libpng keeps the high byte
of a 16-bit grey sample (``"high"``, the store), Pillow's
``convert("L")``/``convert("RGB")`` clip it at 255 (``"clip"``, the
analyzer). Every other 16-bit sample keeps its high byte in both.

Undoing the row filters is the decode's byte loop. :func:`unfilter` runs
it as the compiled host op ``torch.ops.xgan_torch.png_unfilter``
(``xgan_torch/kernels/csrc/png_unfilter.cpp``, built with the kernels;
torch releases the GIL while an op runs, so threads decode in parallel)
or as the plain numpy/Python version :func:`_unfilter`. Card runs use the
op and raise if it does not build; ``--cpu`` runs and the tests use the
plain version.
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


# channels per pixel and the bit depths the format allows, by colour
# type: grey, RGB, palette, grey+alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# the seven Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
GREY16_RULES = ("high", "clip")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Plain version: undo the PNG row filters of ``raw`` (h, 1 + stride)
    -> (h, stride); ``bpp`` bytes per pixel, 1 to 8 (1 below 8 bits).

    None, Sub and Up are whole-row numpy operations; Average and Paeth
    depend on the byte to their left and run as a loop over the row."""
    out = np.zeros((h + 1, stride), np.uint8)  # row 0: the zero prior row
    for y in range(h):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        prior = out[y]
        if kind == 0:
            out[y + 1] = line
        elif kind == 1:  # a running sum over each byte lane of a pixel
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint8)
            lanes[:stride] = line
            out[y + 1] = np.cumsum(lanes.reshape(-1, bpp), axis=0,
                                   dtype=np.uint8).reshape(-1)[:stride]
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
            raise ValueError(f"unknown PNG row filter {kind}")
    return out[1:]


def unfilter(raw: np.ndarray, h: int, stride: int, bpp: int, *,
             compiled: bool = False) -> np.ndarray:
    """(h, 1 + stride) filtered rows -> (h, stride) bytes: the compiled
    op when ``compiled`` (built at first use; a failed build raises),
    else :func:`_unfilter`. Both raise ``ValueError`` on an unknown
    filter type."""
    if compiled:
        import torch
        from xgan_torch.kernels.build import load_ops
        # a writable copy: the inflated bytes are a read-only buffer
        return load_ops().png_unfilter(
            torch.from_numpy(np.require(raw, requirements=("C", "W"))), h,
            stride, bpp).numpy()
    return _unfilter(raw, h, stride, bpp)


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows (h, stride) -> (h, w, ch) samples: uint8 up to 8
    bits (not yet scaled), uint16 at 16."""
    h = rows.shape[0]
    if depth == 16:
        vals = rows.view(">u2").astype(np.uint16)
    elif depth == 8:
        vals = rows
    else:  # 1, 2 or 4 bits, most significant first
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (bits * weights).sum(-1, dtype=np.uint8)
    return vals[:, :w * ch].reshape(h, w, ch)


def _to_rgb(img: np.ndarray, ctype: int, depth: int, palette,
            grey16: str) -> np.ndarray:
    """Samples -> (H, W, 3) uint8 RGB (see the module docstring)."""
    if ctype == 3:
        return palette[np.minimum(img[..., 0], len(palette) - 1)]
    if depth == 16:
        if ctype == 0 and grey16 == "clip":
            img = np.minimum(img, 255).astype(np.uint8)
        else:
            img = (img >> 8).astype(np.uint8)
    elif depth < 8:  # grey: 1, 2, 4 bits scaled to 0..255
        img = img * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):  # grey (+ alpha); a take, which runs without
        return img[..., [0, 0, 0]]  # the GIL, where np.repeat holds it
    return np.ascontiguousarray(img[..., :3])


def decode_png(path: str, *, grey16: str = "high",
               compiled: bool = False) -> np.ndarray:
    """PNG file -> (H, W, 3) uint8 RGB; see the module docstring for the
    conversions and ``grey16``. ``compiled``: undo the row filters with
    the compiled op (see :func:`unfilter`).

    Raises ``ValueError`` for a file that is not a PNG or is corrupt."""
    if grey16 not in GREY16_RULES:
        raise ValueError(f"grey16 must be one of {GREY16_RULES}, got "
                         f"{grey16!r}")
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIG):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr, palette = len(_SIG), [], None, None
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR" and len(body) == 13:
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3],
                                    np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = hdr
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype]
            or interlace > 1 or w == 0 or h == 0):
        raise ValueError(f"{path}: invalid PNG header (size {w}x{h}, bit "
                         f"depth {depth}, colour type {ctype}, interlace "
                         f"{interlace})")
    if ctype == 3 and (palette is None or not len(palette)):
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    bpp = max(1, bits // 8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
        img = (np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
               if interlace else None)
        pos = 0
        for x0, y0, dx, dy in passes:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue  # a pass an image this small does not have
            stride = (pw * bits + 7) // 8
            n = ph * (1 + stride)
            if pos + n > raw.size:
                raise ValueError("the image data ends early")
            rows = unfilter(raw[pos:pos + n].reshape(ph, 1 + stride), ph,
                            stride, bpp, compiled=compiled)
            if img is None:  # the whole image in one pass
                img = _samples(rows, pw, ch, depth)
            else:
                img[y0::dy, x0::dx] = _samples(rows, pw, ch, depth)
            pos += n
    except (zlib.error, ValueError) as e:
        raise ValueError(f"{path}: corrupt PNG image data ({e})") from None
    return _to_rgb(img, ctype, depth, palette, grey16)
