"""Train the DCGAN on the RSNA images on the GPU
(flags and defaults as src/train_gan.py).

    python -m xgan_torch.cli.train_gan --data-dir DIR [--epochs 50] \
        [--batch-size 128] [--image-size 224] [--cpu] ...

Writes ``{output_dir}/gan_images/fake_samples_epoch_EEE_iter_TTTTTT.png``
sheets, ``{model_dir}/gan/{generator,discriminator}_epoch_EEE.pth`` and
``..._final.pth`` reference-layout state dicts,
``{results_dir}/gan_training_history.json`` and
``{figures_dir}/gan_loss_curve.png``, and ``{model_dir}/gan/
snapshot_last.pth`` at every checkpoint: ``--resume-from auto`` continues
the run from it, and a first SIGTERM or SIGINT stops the run at the end of
its epoch with that snapshot saved (exit 0). ``--ema-decay`` adds
``generator_ema_final.pth``, ``--grad-accum A`` splits each update into A
microbatches, ``--steps-per-call K`` replays K steps as one CUDA graph,
``--trace-dir`` writes a profiler trace of one epoch. Runs on the CUDA
device unless ``--cpu`` is given; without a CUDA device it exits 1 with a
structured ``Error:`` line. ``--model-parallel N`` trains replicated
after the JAX CLI's note when N does not divide the ranks (1 without a
launch).

Data parallelism (the JAX CLI's default over every local device) is a
``torchrun`` launch here, one process a card::

    torchrun --nproc-per-node 8 -m xgan_torch.cli.train_gan --data-dir DIR

``--batch-size`` is then the global batch (rounded up to a multiple of
the ranks), each rank trains on its rows with BN statistics, losses and
gradients reduced over all of them (NCCL; gloo with ``--cpu``), rank 0
writes every file, ``--shard-store`` splits the image store over the
ranks and ``--shard-opt-state`` their Adam moments (ZeRO-1). ``--grad-accum``
and ``--steps-per-call`` run there too: K steps with their NCCL
all-reduces are one CUDA graph (gloo cannot be captured, so a gloo launch
on the cards takes K = 1 only). ``--model-parallel N`` with N > 1
dividing the ranks is tensor parallelism on the JAX CLI's ``(data,
model)`` mesh: each group of N ranks splits the wide layers' output
channels (``xgan_torch.parallel.tp``) and sees the same rows, with every
other flag of the launch::

    torchrun --nproc-per-node 4 -m xgan_torch.cli.train_gan --cpu \
        --model-parallel 2 ...

The WGAN-GP and CGAN trainers take the same launch, ``--model-parallel``
included.
"""
from __future__ import annotations

import argparse
import sys

import torch

from xgan_torch import config


def build_parser():
    p = argparse.ArgumentParser(
        description="Train DCGAN on RSNA Pneumonia Dataset (PyTorch/CUDA)")
    config.add_path_args(p)
    config.add_gan_model_args(p, fm_default=64)
    config.add_gan_train_args(p, epochs=50, batch_size=128,
                              vis_batch_size=64, save_interval=500,
                              checkpoint_interval=10)
    add_run_args(p)
    return p


def add_run_args(p: argparse.ArgumentParser) -> None:
    """The run flags of the JAX GAN CLIs: size, seed, dtype, cache, batch
    cap, device, dispatch, tracing and resume, and the sharding flags."""
    p.add_argument("--image-size", type=int, default=224,
                   help="Image size (multiple of 32; 224 = reference)")
    p.add_argument("--seed", type=int, default=0)
    config.add_compute_dtype_arg(p)
    p.add_argument("--cache-dir", type=str, default="./data/cache")
    p.add_argument("--limit-batches", type=int, default=0,
                   help="Debug: cap batches per epoch (0 = all)")
    config.add_device_arg(p)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="Run K training steps per call, replayed as one "
                        "captured CUDA graph (K=1 reproduces the "
                        "reference loop exactly; K>1 amortizes per-step "
                        "launch overhead, with sample-sheet emission "
                        "quantized to chunk boundaries)")
    p.add_argument("--trace-dir", type=str, default="",
                   help="Write a torch.profiler trace of one epoch here, "
                        "and spans.json: the train step's spans per name "
                        "(none for CGAN)")
    p.add_argument("--resume-from", type=str, default="",
                   help="Resume from a snapshot_last.pth ('auto' = pick "
                        "up the run's own last snapshot)")
    config.add_shard_args(p)


def start(args):
    """Join the ranks of a launch (``config.join_ranks``), resolve the
    device (exit 1 with an ``Error:`` line without CUDA and ``--cpu``) and
    the compute dtype, and print the arguments. Returns ``(mesh,
    dtype)``; ``mesh.device`` is the run's device. ``--steps-per-call``
    above 1 on a gloo group on the cards exits 1: a CUDA graph cannot
    capture gloo's collectives."""
    mesh = config.join_ranks(args)
    device = mesh.device
    if (args.steps_per_call > 1 and device.type == "cuda"
            and mesh.backend == "gloo"):
        from xgan_torch.parallel.mesh import shutdown
        shutdown(mesh)
        print(f"Error: --steps-per-call {args.steps_per_call} captures the "
              "steps' all-reduces in a CUDA graph, which needs NCCL on the "
              "cards; gloo's cannot be captured (use --dist-backend nccl, "
              "or --steps-per-call 1)")
        sys.exit(1)
    dtype = config.resolve_dtype(args.compute_dtype, device)
    if device.type == "cuda" and dtype == torch.float32:
        # f32 means f32: cuDNN would otherwise run the convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print("--- Training Arguments ---")
    for k, v in sorted(vars(args).items()):
        print(f"  {k}: {v}")
    print("-------------------------")
    return mesh, dtype


def main(argv=None):
    """Train; returns the history (None after a printed error)."""
    args = build_parser().parse_args(argv)
    mesh, dtype = start(args)
    from xgan_torch.parallel.mesh import shutdown
    from xgan_torch.train.gan_loop import train_dcgan
    try:
        return train_dcgan(args, mesh.device, dtype, mesh)
    finally:
        shutdown(mesh)


if __name__ == "__main__":
    main()
