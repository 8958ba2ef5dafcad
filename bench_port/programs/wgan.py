"""The WGAN-GP step as ``xgan_torch``'s loop drives it
(``train/wgan_loop.py:train_wgan``): G (the DCGAN ladder one width up) and
the critic at the configuration's widths,
:func:`xgan_torch.train.wgan.wgan_step` with ``critic_iters`` updates and
λ on the device store, and on a data-parallel cell a one-rank process
group (:mod:`.common`)."""
from __future__ import annotations

import torch

from .common import Program, assemble, join_one_rank


def build(cfg: dict, cell: dict, store: torch.Tensor, weights: dict,
          draw_seed: int, dtype: torch.dtype) -> Program:
    from xgan_torch.models.wgan import Critic, Generator
    from xgan_torch.train import wgan

    dev = store.device
    mesh = join_one_rank(dev) if cell["dp_world"] else None
    init = torch.Generator(dev).manual_seed(0)  # overwritten by the weights
    g = Generator(cfg["latent_dim"], cfg["num_channels"],
                  cfg["feature_maps_g"], cfg["image_size"], dtype=dtype,
                  device=dev, generator=init)
    c = Critic(cfg["num_channels"], cfg["feature_maps_d"],
               cfg["image_size"], dtype=dtype, device=dev, generator=init)

    def step(g, c, opt_g, opt_c, draws, idx):
        return wgan.wgan_step(g, c, opt_g, opt_c, store, idx,
                              latent_dim=cfg["latent_dim"],
                              critic_iters=cfg["critic_iters"],
                              lambda_gp=cfg["lambda_gp"], dtype=dtype,
                              generator=draws, mesh=mesh)

    return assemble(cfg, cell, weights, draw_seed, g, c, step, mesh)
