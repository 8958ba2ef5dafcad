"""WGAN-GP experiment (role of xgan/train/wgan_loop.py).

Flow: dataset check -> decode-once uint8 train store -> the store on the
device -> G and the critic from the seed, Adam with betas (β1, 0.9) ->
epochs of :func:`wgan_step` over the JAX package's batch order -> sample
sheets ``wgan_images/fake_samples_epoch_EEE_iter_TTTTTT.png``, checkpoints
``wgan/{generator,discriminator}_{epoch_EEE,final}.pth``,
``wgan_training_history.json`` (``D_losses``: every critic update's loss,
in order; ``G_losses``; ``D_losses_epoch``; ``G_losses_epoch``) and
``wgan_loss_curve.png``.

Step losses stay on the device and come to the host once per epoch. Every
sample sheet renders the eval forward of G's current weights, so it
repacks them first. Checkpoints are reference-layout ``.pth`` state dicts
where the JAX package writes ``.msgpack`` (and a ``generator_final.pth``
twin). Resume and preemption (``wgan/snapshot_last.pth``: G, the critic,
both optimizers, the EMA and the step-draw generator), ``--ema-decay``,
``--trace-dir``, ``--grad-accum A`` (every critic update and the G update
as A microbatches) and ``--steps-per-call K`` (K full batches per CUDA
graph replay, the masked tail as one eager step; Adam capturable on the
card for every K) work as in the DCGAN loop
(:mod:`xgan_torch.train.gan_loop`). Not ported yet: several devices.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from xgan_torch.data.pipeline import DeviceStore, minmax_to_u8
from xgan_torch.io_.figures import plot_wgan_losses, save_image_grid
from xgan_torch.models.wgan import Critic, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.ema import ema_update, init_ema
from xgan_torch.train.gan_loop import load_train_store
from xgan_torch.train.loop_common import EpochProgress, EpochRun, \
    epoch_dispatches, epoch_plan, grid_iters, preempt_notice, \
    resolve_grad_accum, resume_preflight, wgan_live_postfix
from xgan_torch.train.multistep import StepsPerCall
from xgan_torch.train.wgan import wgan_step
from xgan_torch.utils import StepTimer, check_create_dir


def train_wgan(args, device: torch.device, dtype: torch.dtype):
    """args: the namespace of ``xgan_torch.cli.train_wggan``. Returns the
    history, or None after a printed error."""
    if not resume_preflight(args):
        return None
    model_dir = check_create_dir(os.path.join(args.model_dir, "wgan"))
    image_dir = check_create_dir(os.path.join(args.output_dir,
                                              "wgan_images"))
    metrics_dir = check_create_dir(args.results_dir)
    figures_dir = check_create_dir(args.figures_dir)

    store = load_train_store(args, device)
    if store is None:
        return None
    print(f"Loaded training data with {len(store)} samples.")
    device_store = DeviceStore(store, device)
    print(f"Device: {device}; compute dtype {dtype}; critic_iters "
          f"{args.critic_iters}; lambda_gp {args.lambda_gp}")

    seeds = [torch.Generator(device).manual_seed(args.seed + i)
             for i in range(4)]
    g = Generator(args.latent_dim, args.num_channels, args.feature_maps_g,
                  args.image_size, dtype=dtype, device=device,
                  generator=seeds[0])
    c = Critic(args.num_channels, args.feature_maps_d, args.image_size,
               dtype=dtype, device=device, generator=seeds[1])
    # Adam betas (beta1, 0.9), as the reference's WGAN-GP trainer; on the
    # card capturable for every K, so that K = 1 trains as K > 1 does
    capturable = device.type == "cuda"
    opt_g = adam(g.parameters(), args.lr, args.beta1, 0.9,
                 capturable=capturable)
    opt_c = adam(c.parameters(), args.lr, args.beta1, 0.9,
                 capturable=capturable)
    print("Generator and Critic initialized.")
    fixed_noise = torch.randn((args.vis_batch_size, args.latent_dim),
                              generator=seeds[2], device=device)
    step_draws = seeds[3]
    ema = init_ema(g) if args.ema_decay > 0 else None
    batch_size = args.batch_size
    ga = resolve_grad_accum(args.grad_accum, batch_size)
    k_steps = max(1, args.steps_per_call)

    def train_step(idx, mask=None):
        losses = wgan_step(g, c, opt_g, opt_c, device_store.images, idx,
                           latent_dim=args.latent_dim,
                           critic_iters=args.critic_iters,
                           lambda_gp=args.lambda_gp, dtype=dtype, mask=mask,
                           generator=step_draws, grad_accum=ga)
        if ema is not None:
            ema_update(ema, g, args.ema_decay)
        return losses

    multi = StepsPerCall(train_step, k_steps, step_draws) \
        if k_steps > 1 else None

    def sample_grid(path):
        g.repack()  # the eval forward reads tensors derived at repack
        imgs = minmax_to_u8(g(fixed_noise))
        save_image_grid(imgs.cpu().numpy(), path, nrow=8)

    history = {"D_losses": [], "G_losses": [], "D_losses_epoch": [],
               "G_losses_epoch": []}
    history_path = os.path.join(metrics_dir, "wgan_training_history.json")
    data_rng = np.random.default_rng(args.seed)
    run = EpochRun(args, model_dir, history_path, history,
                   {"g": g, "c": c}, {"g": opt_g, "c": opt_c}, ema,
                   step_draws)
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
            epoch_losses = []
            with run.traced(epoch), \
                    EpochProgress(f"Epoch {epoch + 1}/{args.epochs}",
                                  num_batches,
                                  postfix_fn=wgan_live_postfix) as progress:
                for i, chunk in epoch_dispatches(
                        num_batches, t_mask is not None, k_steps):
                    if chunk > 1:
                        losses = multi(idx_all[i:i + chunk])
                    else:
                        is_tail = t_mask is not None and i == num_batches - 1
                        losses = train_step(idx_all[i],
                                            t_mask if is_tail else None)
                    losses = losses.reshape(chunk, args.critic_iters + 1)
                    epoch_losses.append(losses)
                    for t in grid_iters(iters, chunk, args.save_interval,
                                        epoch == args.epochs - 1, i,
                                        num_batches):
                        sample_grid(os.path.join(
                            image_dir, f"fake_samples_epoch_"
                            f"{epoch + 1:03d}_iter_{t:06d}.png"))
                    iters += chunk
                    progress.update(i + chunk, losses[-1])
                # one device -> host copy per epoch for all step losses
                el = torch.cat(epoch_losses).cpu().numpy()
            timer.tick(num_batches)
            d_ep, g_ep = el[:, :-1].reshape(-1), el[:, -1]
            history["D_losses"].extend(d_ep.tolist())
            history["G_losses"].extend(g_ep.tolist())
            history["D_losses_epoch"].append(float(d_ep.mean()))
            history["G_losses_epoch"].append(float(g_ep.mean()))
            print(f"Epoch {epoch + 1}/{args.epochs} Summary - "
                  f"Time: {time.time() - epoch_start:.2f}s, "
                  f"Avg Loss_D: {d_ep.mean():.4f}, "
                  f"Avg Loss_G: {g_ep.mean():.4f}, "
                  f"{timer.rate * batch_size:.1f} imgs/s")

            if run.boundary(epoch, iters):
                break
    if run.preempted:
        preempt_notice(run.preempted)
        return history
    print(f"Training finished in {time.time() - start_time:.2f} seconds.")
    run.save_final()
    plot_wgan_losses(history, os.path.join(figures_dir,
                                           "wgan_loss_curve.png"))
    return history
