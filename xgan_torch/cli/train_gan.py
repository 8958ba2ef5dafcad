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
structured ``Error:`` line. Flags of the JAX CLI that this port does not
support yet exit 1 when set away from their default.

Data parallelism (the JAX CLI's default over every local device) is a
``torchrun`` launch here, one process a card::

    torchrun --nproc-per-node 8 -m xgan_torch.cli.train_gan --data-dir DIR

``--batch-size`` is then the global batch (rounded up to a multiple of
the ranks), each rank trains on its rows with BN statistics, losses and
gradients reduced over all of them (NCCL; gloo with ``--cpu``), rank 0
writes every file, and ``--shard-store`` splits the image store over the
ranks. ``--grad-accum`` runs there too; ``--steps-per-call`` exits 1
under a launch. The WGAN-GP and CGAN trainers take the same launch.
"""
from __future__ import annotations

import argparse

import torch

from xgan_torch import config

# flag -> its default: other values are not supported by the port yet
UNSUPPORTED = {"shard_opt_state": False, "model_parallel": 1}
# the loop flags of the three GAN trainers that do not run across ranks
# yet
DP_REFUSED = {"steps_per_call": 1}


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
    cap, device, dispatch, tracing and resume, and the flags the port does
    not support yet."""
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
                   help="Write a torch.profiler trace of one epoch here")
    p.add_argument("--resume-from", type=str, default="",
                   help="Resume from a snapshot_last.pth ('auto' = pick "
                        "up the run's own last snapshot)")
    # flags of the JAX CLI that the port does not support yet
    p.add_argument("--shard-store", action="store_true",
                   help="Split the image store over the data-parallel "
                        "ranks (a no-op on one rank)")
    p.add_argument("--shard-opt-state", action="store_true",
                   help="(not supported by xgan_torch yet)")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="(not supported by xgan_torch yet)")


def start(args, unsupported: dict = UNSUPPORTED,
          dp_refused: dict | None = DP_REFUSED):
    """Refuse the ``unsupported`` flags (dest -> the one value the port
    takes), join the ranks of a launch (``config.join_ranks``: refuses
    ``dp_refused`` there, or the launch itself when None), resolve the
    device (exit 1 with an ``Error:`` line without CUDA and ``--cpu``) and
    the compute dtype, and print the arguments. Returns ``(mesh,
    dtype)``; ``mesh.device`` is the run's device."""
    config.refuse_unsupported(args, unsupported)
    mesh = config.join_ranks(args, dp_refused)
    device = mesh.device
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
