"""DCGAN experiment (role of xgan/train/gan_loop.py).

Flow: dataset check -> decode-once uint8 train store -> the store on the
device -> G and D from the seed -> epochs of :func:`dcgan_step` over the
JAX package's batch order -> sample sheets, checkpoints, the history
JSON and ``gan_loss_curve.png`` in the reference's names and keys.

Per-step metrics stay on the device and come to the host once per epoch.
Every sample sheet renders the eval forward of G's current weights, so it
repacks them first. Checkpoints are reference-layout ``.pth`` state
dicts where the JAX package writes ``.msgpack``: flax serialization is
absent on the GPU host.

The loop features, in the JAX loop's order: the ``--resume-from`` check
before the dataset is decoded; the snapshot manager and ``try_resume``
(G, D, both optimizers, the EMA, the step-draw generator), the batch
order replayed past the trained epochs and the prior history merged; a
first SIGTERM/SIGINT stops the run at its epoch boundary with a snapshot
(``GracefulShutdown``); ``--trace-dir`` profiles one epoch; every
checkpoint, the snapshot and the history go through one async writer,
flushed on every exit path. ``--ema-decay`` updates an f32 EMA of G's
parameters after each G step (``generator_ema_final.pth``);
``--grad-accum A`` runs each update as A microbatches;
``--steps-per-call K`` dispatches K full batches per call through
:class:`~xgan_torch.train.multistep.StepsPerCall` (one CUDA graph
replay), the masked tail batch as one eager step. Not ported yet:
several devices (ROADMAP A14).
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
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.ema import ema_update, init_ema
from xgan_torch.train.gan import dcgan_step
from xgan_torch.train.loop_common import EpochProgress, EpochRun, \
    epoch_dispatches, epoch_plan, gan_live_postfix, grid_iters, \
    preempt_notice, resolve_grad_accum, resume_preflight
from xgan_torch.train.multistep import StepsPerCall
from xgan_torch.utils import StepTimer, check_create_dir

HISTORY_KEYS = ("G_losses_iter", "D_losses_iter", "D_x_iter", "D_G_z1_iter",
                "D_G_z2_iter", "G_losses_epoch", "D_losses_epoch")


def load_train_store(args, device: torch.device):
    """The decode-once uint8 train store, or None after a printed error;
    a run on the card decodes with the compiled PNG unfilter."""
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
                            workers=args.workers,
                            compiled=device.type == "cuda")


def train_dcgan(args, device: torch.device, dtype: torch.dtype):
    """args: the namespace of ``xgan_torch.cli.train_gan``. Returns the
    history, or None after a printed error."""
    if not resume_preflight(args):
        return None
    gan_model_dir = check_create_dir(os.path.join(args.model_dir, "gan"))
    gan_output_dir = check_create_dir(
        os.path.join(args.output_dir, "gan_images"))
    metrics_dir = check_create_dir(args.results_dir)
    figures_dir = check_create_dir(args.figures_dir)

    store = load_train_store(args, device)
    if store is None:
        return None
    print(f"Loaded training data with {len(store)} samples.")
    device_store = DeviceStore(store, device)
    print(f"Device: {device}; compute dtype {dtype}")
    batch_size = args.batch_size

    seeds = [torch.Generator(device).manual_seed(args.seed + i)
             for i in range(4)]
    g = Generator(args.latent_dim, args.num_channels, args.feature_maps_g,
                  args.image_size, dtype=dtype, device=device,
                  generator=seeds[0])
    d = Discriminator(args.num_channels, args.feature_maps_d,
                      args.image_size, dtype=dtype, device=device,
                      generator=seeds[1])
    k_steps = max(1, args.steps_per_call)
    # on the card, Adam's update stays on the device for every K: a step
    # inside a CUDA graph needs it, and K = 1 then trains as K > 1 does
    capturable = device.type == "cuda"
    opt_g = adam(g.parameters(), args.lr, args.beta1, capturable=capturable)
    opt_d = adam(d.parameters(), args.lr, args.beta1, capturable=capturable)
    print("Generator and Discriminator initialized.")
    fixed_noise = torch.randn((args.vis_batch_size, args.latent_dim),
                              generator=seeds[2], device=device)
    step_draws = seeds[3]

    # --ema-decay: an f32 EMA of G's parameters, written after each G step
    # and read by nothing in training
    ema = init_ema(g) if args.ema_decay > 0 else None
    ga = resolve_grad_accum(args.grad_accum, batch_size)

    def train_step(idx, mask=None):
        metrics = dcgan_step(g, d, opt_g, opt_d, device_store.images, idx,
                             latent_dim=args.latent_dim, dtype=dtype,
                             mask=mask, generator=step_draws,
                             grad_accum=ga)
        if ema is not None:
            ema_update(ema, g, args.ema_decay)
        return metrics

    multi = StepsPerCall(train_step, k_steps, step_draws) \
        if k_steps > 1 else None

    def sample_grid(path):
        g.repack()  # the eval forward reads tensors derived at repack
        imgs = minmax_to_u8(g(fixed_noise))
        save_image_grid(imgs.cpu().numpy(), path, nrow=8)

    data_rng = np.random.default_rng(args.seed)
    run = EpochRun(args, gan_model_dir,
                   os.path.join(metrics_dir, "gan_training_history.json"),
                   {k: [] for k in HISTORY_KEYS}, {"g": g, "d": d},
                   {"g": opt_g, "d": opt_d}, ema, step_draws)
    if not run.resume(len(store), batch_size, data_rng):
        return None
    history, iters = run.history, run.iters

    timer = StepTimer(device)
    start_time = time.time()
    print("Starting Training Loop...")
    with run:
        for epoch in run.epochs():
            epoch_start = time.time()
            idx_all, t_mask = epoch_plan(len(store), batch_size, data_rng,
                                         args.limit_batches, device)
            num_batches = idx_all.shape[0]
            epoch_metrics = []
            with run.traced(epoch), \
                    EpochProgress(f"Epoch {epoch + 1}/{args.epochs}",
                                  num_batches,
                                  postfix_fn=gan_live_postfix) as progress:
                for i, chunk in epoch_dispatches(
                        num_batches, t_mask is not None, k_steps):
                    if chunk > 1:
                        metrics = multi(idx_all[i:i + chunk])
                    else:
                        is_tail = t_mask is not None and i == num_batches - 1
                        metrics = train_step(idx_all[i],
                                             t_mask if is_tail else None)
                    epoch_metrics.append(metrics.reshape(-1, 5))
                    for t in grid_iters(iters, chunk, args.save_interval,
                                        epoch == args.epochs - 1, i,
                                        num_batches):
                        sample_grid(os.path.join(
                            gan_output_dir, f"fake_samples_epoch_"
                            f"{epoch + 1:03d}_iter_{t:06d}.png"))
                    iters += chunk
                    progress.update(i + chunk, metrics)
                # one device -> host copy per epoch for all step metrics
                em = torch.cat(epoch_metrics).cpu().numpy()
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

            if run.boundary(epoch, iters):
                break
    if run.preempted:
        preempt_notice(run.preempted)
        return history
    print(f"Training finished in {time.time() - start_time:.2f} seconds.")
    run.save_final()
    plot_gan_losses(history, os.path.join(figures_dir, "gan_loss_curve.png"))
    return history
