"""CGAN experiment (role of xgan/train/cgan_loop.py).

Flow: the ``--vgg-path`` check (a missing or non-vgg16 file prints an
``Error:`` line and returns None before anything is decoded) -> dataset
check -> decode-once uint8 train store -> the store on the device -> G,
D and the VGG16 features from the seed (ImageNet weights from
``--vgg-path``, else random features and a warning) -> epochs of
:func:`cgan_step` over the JAX package's batch order, the tail batch
masked -> sample sheets ``cgan_images/fake_samples_epoch_EEE_iter_TTTTTT
.png`` of the fixed noise with labels ``0, 1, 0, 1, ...``, checkpoints
``cgan/{generator,discriminator}_{epoch_EEE,final}.pth``,
``cgan_training_history.json`` (the JAX package's nine keys) and
``cgan_loss_curve.png``.

Step metrics stay on the device and come to the host once per epoch.
Checkpoints are reference-layout ``.pth`` state dicts where the JAX
package writes ``.msgpack``. Resume and preemption
(``cgan/snapshot_last.pth``: G, D, both optimizers, the EMA and the
step-draw generator), ``--ema-decay`` and ``--trace-dir`` work as in the
DCGAN loop (:mod:`xgan_torch.train.gan_loop`), and so do ``--grad-accum
A`` (the D and G updates as A microbatches) and ``--steps-per-call K``
(K full batches per CUDA graph replay, the masked tail as one eager step;
Adam capturable on the card for every K). The adaptive gate reads the
run's epoch as a device scalar, which a graph captured at one epoch reads
anew at every replay, so after a resume it opens from epoch 5 of the
run, not of the process. A ``torchrun`` launch (``mesh``) runs as in the
DCGAN loop: the global batch padded to a multiple of the ranks, each
rank's rows of every step (:func:`~xgan_torch.train.cgan.cgan_step`, the
gate on the global D(x) and D(G(z))), ``--shard-store``, rank 0 alone
writing, every rank loading the same ``--vgg-path`` or drawing the same
random VGG16 from the seed; ``--shard-opt-state`` and
``--steps-per-call`` (the gate's all-reduced D(x) and D(G(z)) inside the
captured steps) run there too. ``--model-parallel N`` (``mesh`` is then
the data group of the ``(data, model)`` layout, carrying the model group)
places G and D over the model group after init, before the optimizers
and the EMA, as the DCGAN loop does, and leaves the frozen VGG16 whole on
every rank, as the JAX loop replicates it: every rank renders the sheets
(the eval forward gathers over the model group) and assembles the
checkpoints, the snapshot and the EMA whole, rank 0 writes them, and a
resume cuts them again.
"""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch

from xgan_torch.data.pipeline import DeviceStore, minmax_to_u8
from xgan_torch.io_.figures import plot_cgan_losses, save_image_grid
from xgan_torch.models.cgan import Discriminator, Generator
from xgan_torch.models.layers import sync_batch_norm
from xgan_torch.models.vgg import VGG16Features, load_vgg16_pth, \
    read_vgg16_pth
from xgan_torch.parallel.mesh import MeshContext
from xgan_torch.parallel.tp import opt_from_args, shard_over_model
from xgan_torch.train.cgan import cgan_step
from xgan_torch.train.common import adam
from xgan_torch.train.ema import ema_update, init_ema
from xgan_torch.train.gan_loop import load_train_store
from xgan_torch.train.loop_common import EpochProgress, EpochRun, \
    epoch_dispatches, epoch_plan, gan_live_postfix, grid_iters, \
    preempt_notice, resolve_grad_accum, resume_preflight
from xgan_torch.train.multistep import StepsPerCall
from xgan_torch.utils import StepTimer, check_create_dir

NUM_CLASSES = 2
HISTORY_KEYS = ("G_losses_iter", "D_losses_iter", "D_x_iter", "D_G_z1_iter",
                "D_G_z2_iter", "G_losses_epoch", "D_losses_epoch",
                "perceptual_losses", "feature_matching_losses")


def check_vgg_path(vgg_path: str) -> bool:
    """False after a printed ``Error:`` line when ``--vgg-path`` names a
    missing file or one that is not a torchvision vgg16 state dict."""
    if not vgg_path:
        return True
    if not os.path.exists(vgg_path):
        print(f"Error: VGG16 checkpoint {vgg_path} not found.")
        return False
    try:
        read_vgg16_pth(vgg_path)
    except (ValueError, RuntimeError, OSError, pickle.UnpicklingError) as e:
        print(f"Error: --vgg-path {vgg_path} is not a vgg16 checkpoint: {e}")
        return False
    return True


def train_cgan(args, device: torch.device, dtype: torch.dtype,
               mesh: MeshContext | None = None):
    """args: the namespace of ``xgan_torch.cli.train_cgan``. Returns the
    history, or None after a printed error. ``mesh``: this process's rank
    of a data-parallel run (None: the only one)."""
    mesh = mesh if mesh is not None else MeshContext(device)
    if not resume_preflight(args) or not check_vgg_path(args.vgg_path):
        return None
    model_dir = check_create_dir(os.path.join(args.model_dir, "cgan"))
    image_dir = check_create_dir(os.path.join(args.output_dir,
                                              "cgan_images"))
    metrics_dir = check_create_dir(args.results_dir)
    figures_dir = check_create_dir(args.figures_dir)

    with mesh.main_first():
        store = load_train_store(args, device)
    if store is None:
        return None
    print(f"Loaded training data with {len(store)} samples.")
    device_store = DeviceStore(store, device, mesh,
                               shard=getattr(args, "shard_store", False))
    batch_size = mesh.pad_batch(args.batch_size)
    if batch_size != args.batch_size:
        print(f"Note: batch size {args.batch_size} -> {batch_size} "
              f"(multiple of {mesh.n_data} devices)")
    print(f"Device: {device}; compute dtype {dtype}; rank {mesh.rank} of "
          f"{mesh.world}")

    seeds = [torch.Generator(device).manual_seed(args.seed + i)
             for i in range(5)]
    g = Generator(args.latent_dim, NUM_CLASSES, args.num_channels,
                  args.feature_maps_g, args.image_size, dtype=dtype,
                  device=device, generator=seeds[0])
    d = Discriminator(NUM_CLASSES, args.num_channels, args.feature_maps_d,
                      args.image_size, dtype=dtype, device=device,
                      generator=seeds[1])
    sync_batch_norm(g, mesh)
    sync_batch_norm(d, mesh)
    if mesh.model is not None:  # never the frozen VGG16: it stays whole
        shard_over_model([g, d], mesh.model)
    vgg = VGG16Features(dtype=dtype, device=device, generator=seeds[2])
    if args.vgg_path:
        load_vgg16_pth(vgg, args.vgg_path)
        print(f"Loaded VGG16 ImageNet weights from {args.vgg_path}")
    else:
        print("WARNING: no --vgg-path given; perceptual loss uses "
              "randomly-initialized VGG features (random-feature perceptual "
              "losses still provide a training signal, but quality parity "
              "with the reference needs the ImageNet checkpoint).")
    # on the card capturable for every K, so that K = 1 trains as K > 1
    capturable = device.type == "cuda"
    opt_g = opt_from_args(args, adam(g.parameters(), args.lr, args.beta1,
                                     capturable=capturable), [g], mesh)
    opt_d = opt_from_args(args, adam(d.parameters(), args.lr, args.beta1,
                                     capturable=capturable), [d], mesh)
    print("Generator and Discriminator initialized.")
    fixed_noise = torch.randn((args.vis_batch_size, args.latent_dim),
                              generator=seeds[3], device=device)
    fixed_labels = torch.from_numpy(
        np.tile(np.arange(NUM_CLASSES),
                args.vis_batch_size // NUM_CLASSES + 1)
        [:args.vis_batch_size]).to(device)
    step_draws = seeds[4]
    ema = init_ema(g) if args.ema_decay > 0 else None
    ga = resolve_grad_accum(args.grad_accum, batch_size)
    k_steps = max(1, args.steps_per_call)

    def train_step(idx, epoch, mask=None):
        metrics = cgan_step(g, d, vgg, opt_g, opt_d, device_store.images,
                            device_store.labels, idx, epoch,
                            latent_dim=args.latent_dim, dtype=dtype,
                            mask=mask, generator=step_draws, grad_accum=ga,
                            take=device_store.take, mesh=mesh)
        if ema is not None:
            ema_update(ema, g, args.ema_decay)
        return metrics

    multi = StepsPerCall(train_step, k_steps, step_draws) \
        if k_steps > 1 else None

    def sample_grid(path):
        if not mesh.is_main and mesh.model is None:
            return  # under tensor parallelism every rank renders
        imgs = minmax_to_u8(g(fixed_noise, fixed_labels))
        if mesh.is_main:
            save_image_grid(imgs.cpu().numpy(), path, nrow=8)

    history = {k: [] for k in HISTORY_KEYS}
    history_path = os.path.join(metrics_dir, "cgan_training_history.json")
    data_rng = np.random.default_rng(args.seed)
    run = EpochRun(args, model_dir, history_path, history,
                   {"g": g, "d": d}, {"g": opt_g, "d": opt_d}, ema,
                   step_draws, mesh)
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
            # the run's epoch, on the device: the gate holds open for its
            # first 5, also inside a graph captured at an earlier epoch
            epoch_t = torch.tensor(epoch, device=device)
            epoch_metrics = []
            with run.traced(epoch), \
                    EpochProgress(f"Epoch {epoch + 1}/{args.epochs}",
                                  num_batches,
                                  postfix_fn=gan_live_postfix) as progress:
                for i, chunk in epoch_dispatches(
                        num_batches, t_mask is not None, k_steps):
                    if chunk > 1:
                        metrics = multi(idx_all[i:i + chunk], epoch_t)
                    else:
                        is_tail = t_mask is not None and i == num_batches - 1
                        metrics = train_step(idx_all[i], epoch_t,
                                             t_mask if is_tail else None)
                    epoch_metrics.append(metrics.reshape(chunk, -1))
                    for t in grid_iters(iters, chunk, args.save_interval,
                                        epoch == args.epochs - 1, i,
                                        num_batches):
                        sample_grid(os.path.join(
                            image_dir, f"fake_samples_epoch_"
                            f"{epoch + 1:03d}_iter_{t:06d}.png"))
                    iters += chunk
                    progress.update(i + chunk, metrics)
                # one device -> host copy per epoch for all step metrics
                em = torch.cat(epoch_metrics).cpu().numpy()
            timer.tick(num_batches)
            for col, key in enumerate(HISTORY_KEYS[:5]):
                history[key].extend(em[:, col].tolist())
            for col, key in ((0, "G_losses_epoch"), (1, "D_losses_epoch"),
                             (5, "perceptual_losses"),
                             (6, "feature_matching_losses")):
                history[key].append(float(em[:, col].mean()))
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
    if mesh.is_main:
        plot_cgan_losses(history, os.path.join(figures_dir,
                                               "cgan_loss_curve.png"))
    return history
