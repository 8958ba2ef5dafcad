"""Image sheets (role of xgan/io_/figures.py's ``save_image_grid``),
written with the port's own PNG encoder: the GPU host has no PIL."""
from __future__ import annotations

import os

import numpy as np

from xgan_torch.native.png import encode_png


def save_image_grid(images_u8: np.ndarray, path: str, nrow: int = 8,
                    pad: int = 2) -> None:
    """Tile (B, S, S, 3) uint8 images into one PNG: ``min(B, nrow)``
    columns, ``pad`` white pixels around and between them (the layout of
    the JAX package's sheets and of torchvision's ``save_image``)."""
    b, s, _, c = images_u8.shape
    if b == 0:
        raise ValueError("save_image_grid: empty image batch")
    ncol = min(b, nrow)
    nrows = (b + ncol - 1) // ncol
    canvas = np.full((nrows * (s + pad) + pad, ncol * (s + pad) + pad, c),
                     255, np.uint8)
    for i in range(b):
        r, col = divmod(i, ncol)
        y = pad + r * (s + pad)
        x = pad + col * (s + pad)
        canvas[y:y + s, x:x + s] = images_u8[i]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(canvas))
