"""DCGAN experiment (role of xgan/train/gan_loop.py).

Flow: dataset check -> decode-once uint8 train store -> the store on the
device -> G and D from the seed -> epochs of :func:`dcgan_step` over the
JAX package's batch order -> sample sheets, checkpoints, the history
JSON and ``gan_loss_curve.png`` in the reference's names and keys.

Per-step metrics stay on the device and come to the host once per epoch.
Every sample sheet renders the eval forward of G's current weights, so it
repacks them first. Checkpoints are reference-layout ``.pth`` state
dicts where the JAX package writes ``.msgpack``: flax serialization is
absent on the GPU host. Not ported yet (ROADMAP A13): snapshots and
resume, EMA, gradient accumulation, K > 1 steps per call, tracing and
several devices.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from xgan_torch.data import rsna
from xgan_torch.data.pipeline import DeviceStore, minmax_to_u8
from xgan_torch.data.store import ImageStore
from xgan_torch.io_.figures import plot_gan_losses, save_image_grid
from xgan_torch.io_.metrics import write_json
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.gan import dcgan_step
from xgan_torch.train.loop_common import EpochProgress, \
    checkpoint_boundary, epoch_plan, gan_live_postfix, grid_iters, \
    save_gan_checkpoints
from xgan_torch.utils import StepTimer, check_create_dir

HISTORY_KEYS = ("G_losses_iter", "D_losses_iter", "D_x_iter", "D_G_z1_iter",
                "D_G_z2_iter", "G_losses_epoch", "D_losses_epoch")


def load_train_store(args):
    """The decode-once uint8 train store, or None after a printed error."""
    if not rsna.check_dataset_availability(args.data_dir):
        print(f"Error: Dataset not available in {args.data_dir}. "
              "Run `python src/download_dataset.py` first.")
        return None
    ids, labels = rsna.load_train_metadata(
        os.path.join(args.data_dir, "stage2_train_metadata.csv"))
    print(f"Decoding/loading {len(ids)} training images at "
          f"{args.image_size}px (cached)...")
    return ImageStore.build(rsna.train_paths(args.data_dir, ids), labels,
                            args.image_size, cache_dir=args.cache_dir,
                            name=f"train{args.image_size}",
                            workers=args.workers)


def train_dcgan(args, device: torch.device, dtype: torch.dtype):
    """args: the namespace of ``xgan_torch.cli.train_gan``. Returns the
    history, or None after a printed error."""
    gan_model_dir = check_create_dir(os.path.join(args.model_dir, "gan"))
    gan_output_dir = check_create_dir(
        os.path.join(args.output_dir, "gan_images"))
    metrics_dir = check_create_dir(args.results_dir)
    figures_dir = check_create_dir(args.figures_dir)

    store = load_train_store(args)
    if store is None:
        return None
    print(f"Loaded training data with {len(store)} samples.")
    device_store = DeviceStore(store, device)
    print(f"Device: {device}; compute dtype {dtype}")

    seeds = [torch.Generator(device).manual_seed(args.seed + i)
             for i in range(4)]
    g = Generator(args.latent_dim, args.num_channels, args.feature_maps_g,
                  args.image_size, dtype=dtype, device=device,
                  generator=seeds[0])
    d = Discriminator(args.num_channels, args.feature_maps_d,
                      args.image_size, dtype=dtype, device=device,
                      generator=seeds[1])
    opt_g = adam(g.parameters(), args.lr, args.beta1)
    opt_d = adam(d.parameters(), args.lr, args.beta1)
    print("Generator and Discriminator initialized.")
    fixed_noise = torch.randn((args.vis_batch_size, args.latent_dim),
                              generator=seeds[2], device=device)
    step_draws = seeds[3]

    def sample_grid(path):
        g.repack()  # the eval forward reads tensors derived at repack
        imgs = minmax_to_u8(g(fixed_noise))
        save_image_grid(imgs.cpu().numpy(), path, nrow=8)

    history = {k: [] for k in HISTORY_KEYS}
    data_rng = np.random.default_rng(args.seed)
    batch_size = args.batch_size
    timer = StepTimer(device)
    start_time = time.time()
    iters = 0
    print("Starting Training Loop...")
    for epoch in range(args.epochs):
        epoch_start = time.time()
        idx_all, t_mask = epoch_plan(len(store), batch_size, data_rng,
                                     args.limit_batches, device)
        num_batches = idx_all.shape[0]
        epoch_metrics = []
        with EpochProgress(f"Epoch {epoch + 1}/{args.epochs}", num_batches,
                           postfix_fn=gan_live_postfix) as progress:
            for i in range(num_batches):
                is_tail = t_mask is not None and i == num_batches - 1
                metrics = dcgan_step(
                    g, d, opt_g, opt_d, device_store.images, idx_all[i],
                    latent_dim=args.latent_dim, dtype=dtype,
                    mask=t_mask if is_tail else None, generator=step_draws)
                epoch_metrics.append(metrics)
                for t in grid_iters(iters, args.save_interval,
                                    epoch == args.epochs - 1, i,
                                    num_batches):
                    sample_grid(os.path.join(
                        gan_output_dir, f"fake_samples_epoch_{epoch + 1:03d}"
                        f"_iter_{t:06d}.png"))
                iters += 1
                progress.update(i + 1, metrics)
        # one device -> host copy per epoch for all per-step metrics
        em = torch.stack(epoch_metrics).cpu().numpy()
        timer.tick(num_batches)
        for col, key in enumerate(HISTORY_KEYS[:5]):
            history[key].extend(em[:, col].tolist())
        history["G_losses_epoch"].append(float(em[:, 0].mean()))
        history["D_losses_epoch"].append(float(em[:, 1].mean()))
        print(f"Epoch {epoch + 1}/{args.epochs} Summary - "
              f"Time: {time.time() - epoch_start:.2f}s, "
              f"Avg Loss_D: {em[:, 1].mean():.4f}, "
              f"Avg Loss_G: {em[:, 0].mean():.4f}, "
              f"{timer.rate * batch_size:.1f} imgs/s")

        if checkpoint_boundary(epoch, args.epochs, args.checkpoint_interval):
            save_gan_checkpoints(gan_model_dir, f"epoch_{epoch + 1:03d}", g,
                                 d)
            print(f"Saved checkpoints for epoch {epoch + 1} to "
                  f"{gan_model_dir}")

    print(f"Training finished in {time.time() - start_time:.2f} seconds.")
    save_gan_checkpoints(gan_model_dir, "final", g, d)
    print(f"Saved final models to {gan_model_dir}")
    write_json(os.path.join(metrics_dir, "gan_training_history.json"),
               history)
    plot_gan_losses(history, os.path.join(figures_dir, "gan_loss_curve.png"))
    return history
