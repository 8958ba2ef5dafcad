"""Train the WGAN-GP on the RSNA images on the GPU
(flags and defaults as src/train_wggan.py).

    python -m xgan_torch.cli.train_wggan --data-dir DIR [--epochs 30] \
        [--batch-size 64] [--critic-iters 5] [--lambda-gp 10] [--cpu] ...

Writes ``{output_dir}/wgan_images/fake_samples_epoch_EEE_iter_TTTTTT.png``
sheets, ``{model_dir}/wgan/{generator,discriminator}_epoch_EEE.pth`` and
``..._final.pth`` reference-layout state dicts,
``{results_dir}/wgan_training_history.json`` and
``{figures_dir}/wgan_loss_curve.png``. Runs on the CUDA device unless
``--cpu`` is given; without a CUDA device it exits 1 with a structured
``Error:`` line. ``--resume-from``, ``--ema-decay``, ``--trace-dir``,
``--grad-accum`` and ``--steps-per-call`` work as in the DCGAN trainer
(the snapshot is ``{model_dir}/wgan/snapshot_last.pth``); the flags the
DCGAN trainer does not support exit 1. A ``torchrun`` launch trains
across ranks as the DCGAN trainer does::

    torchrun --nproc-per-node 8 -m xgan_torch.cli.train_wggan --data-dir DIR

(``--batch-size`` the global batch, ``--shard-store`` splitting the store,
rank 0 writing every file; ``--steps-per-call`` above 1 exits 1 on a gloo
group on the cards). ``--model-parallel N`` with N > 1 dividing the ranks
is tensor parallelism on the JAX CLI's ``(data, model)`` mesh, as in the
DCGAN trainer: G's wide ConvTs and the critic's wide convs split their
output channels over each group of N ranks (``xgan_torch.models.wgan``),
and the gradient penalty's double backward crosses the model group.
"""
from __future__ import annotations

import argparse

from xgan_torch import config
from xgan_torch.cli import train_gan

def build_parser():
    p = argparse.ArgumentParser(
        description="Train Wasserstein GAN-GP on RSNA Pneumonia images "
                    "(PyTorch/CUDA)")
    config.add_path_args(p)
    config.add_gan_model_args(p, fm_default=64)
    config.add_gan_train_args(p, epochs=30, batch_size=64,
                              vis_batch_size=64, save_interval=500,
                              checkpoint_interval=10)
    p.add_argument("--critic-iters", type=int, default=5,
                   help="Number of D updates per G update")
    p.add_argument("--lambda-gp", type=float, default=10.,
                   help="Gradient penalty coefficient")
    train_gan.add_run_args(p)
    return p


def main(argv=None):
    """Train; returns the history (None after a printed error)."""
    args = build_parser().parse_args(argv)
    mesh, dtype = train_gan.start(args)
    from xgan_torch.parallel.mesh import shutdown
    from xgan_torch.train.wgan_loop import train_wgan
    try:
        return train_wgan(args, mesh.device, dtype, mesh)
    finally:
        shutdown(mesh)


if __name__ == "__main__":
    main()
