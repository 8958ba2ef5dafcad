"""The DCGAN step as ``xgan_torch``'s loop drives it
(``train/gan_loop.py:train_dcgan``): G and D at the configuration's
widths, :func:`xgan_torch.train.gan.dcgan_step` on the device store, and
on a data-parallel cell a one-rank process group (:mod:`.common`)."""
from __future__ import annotations

import torch

from .common import Program, assemble, join_one_rank


def build(cfg: dict, cell: dict, store: torch.Tensor, weights: dict,
          draw_seed: int, dtype: torch.dtype) -> Program:
    from xgan_torch.models.dcgan import Discriminator, Generator
    from xgan_torch.train import gan

    dev = store.device
    mesh = join_one_rank(dev) if cell["dp_world"] else None
    init = torch.Generator(dev).manual_seed(0)  # overwritten by the weights
    g = Generator(cfg["latent_dim"], cfg["num_channels"],
                  cfg["feature_maps_g"], cfg["image_size"], dtype=dtype,
                  device=dev, generator=init)
    d = Discriminator(cfg["num_channels"], cfg["feature_maps_d"],
                      cfg["image_size"], dtype=dtype, device=dev,
                      generator=init)

    def step(g, d, opt_g, opt_d, draws, idx):
        return gan.dcgan_step(g, d, opt_g, opt_d, store, idx,
                              latent_dim=cfg["latent_dim"], dtype=dtype,
                              generator=draws, mesh=mesh)

    return assemble(cfg, cell, weights, draw_seed, g, d, step, mesh)
