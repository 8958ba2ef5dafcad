"""GAN figures (role of xgan/io_/figures.py): the per-iteration loss
curves of the DCGAN and WGAN-GP trainers, the CGAN trainer's two panels
of per-epoch curves and the image sheets, drawn by
``xgan_torch.io_.plots`` and written with the port's own PNG encoder: the
GPU host has neither matplotlib nor PIL."""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from xgan_torch.io_ import plots
from xgan_torch.native.png import encode_png


def plot_gan_losses(history: Dict, output_path: str) -> None:
    """Per-iteration G/D loss curves (DCGAN schema), or a printed warning
    when either series is missing."""
    g = history.get("G_losses_iter", [])
    d = history.get("D_losses_iter", [])
    if not g or not d:
        print("Warning: loss data missing; skipping plot.")
        return
    canvas, _ = plots.chart(
        [plots.Line(range(len(g)), g, plots.CYCLE[0], alpha=0.8,
                    label="Generator Loss"),
         plots.Line(range(len(d)), d, plots.CYCLE[1], alpha=0.8,
                    label="Discriminator Loss")],
        title="Generator and Discriminator Loss During Training "
              "(Per Iteration)",
        xlabel="Iterations", ylabel="Loss (BCE)", size=(1200, 600),
        grid_style="--")
    plots.save_png(canvas, output_path)
    print(f"Saved GAN loss plot to {output_path}")


def plot_cgan_losses(history: Dict, output_path: str) -> None:
    """Two panels of per-epoch curves (CGAN schema), the JAX writer's
    stacked subplots: G and D losses above, the perceptual and
    feature-matching losses below; or a printed warning when the G or D
    series is missing."""
    g = history.get("G_losses_epoch", [])
    d = history.get("D_losses_epoch", [])
    if not g or not d:
        print("Warning: loss data missing; skipping plot.")
        return
    panels = []
    for (a, a_label), (b, b_label), title in (
            ((g, "Generator Loss"), (d, "Discriminator Loss"),
             "Generator and Discriminator Loss During Training "
             "(Per Epoch)"),
            ((history.get("perceptual_losses", []), "Perceptual Loss"),
             (history.get("feature_matching_losses", []),
              "Feature Matching Loss"),
             "Additional Loss Components During Training")):
        canvas, _ = plots.chart(
            [plots.Line(range(1, len(a) + 1), a, plots.CYCLE[0], alpha=0.8,
                        label=a_label),
             plots.Line(range(1, len(b) + 1), b, plots.CYCLE[1], alpha=0.8,
                        label=b_label)],
            title=title, xlabel="Epochs", ylabel="Loss", size=(1200, 300),
            grid_style="--")
        panels.append(canvas)
    plots.save_png(np.concatenate(panels, axis=0), output_path)
    print(f"Saved GAN loss plot to {output_path}")


def plot_wgan_losses(history: Dict, output_path: str) -> None:
    """Per-iteration critic and G loss curves (WGAN-GP schema): every
    critic update's loss and every G update's loss, each against its own
    count, as the JAX writer draws them."""
    d = history.get("D_losses", [])
    g = history.get("G_losses", [])
    canvas, _ = plots.chart(
        [plots.Line(range(len(d)), d, plots.CYCLE[0],
                    label="Critic (D) Loss"),
         plots.Line(range(len(g)), g, plots.CYCLE[1],
                    label="Generator Loss")],
        xlabel="Iterations", ylabel="Loss", size=(1200, 600))
    plots.save_png(canvas, output_path)
    print(f"Saved GAN loss plot to {output_path}")


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
