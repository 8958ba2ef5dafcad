"""Train the conditional GAN on the RSNA images on the GPU
(flags and defaults as src/train_cgan.py).

    python -m xgan_torch.cli.train_cgan --data-dir DIR [--epochs 50] \
        [--batch-size 32] [--vgg-path vgg16.pth] [--cpu] ...

Writes ``{output_dir}/cgan_images/fake_samples_epoch_EEE_iter_TTTTTT.png``
sheets, ``{model_dir}/cgan/{generator,discriminator}_epoch_EEE.pth`` and
``..._final.pth`` reference-layout state dicts,
``{results_dir}/cgan_training_history.json`` and
``{figures_dir}/cgan_loss_curve.png``. ``--vgg-path`` names a torchvision
vgg16 ``.pth`` for the perceptual loss; without it the VGG features are
random (a warning says so). Runs on the CUDA device unless ``--cpu`` is
given; without a CUDA device it exits 1 with a structured ``Error:``
line. ``--resume-from``, ``--ema-decay``, ``--trace-dir``,
``--grad-accum`` and ``--steps-per-call`` work as in the DCGAN trainer
(the snapshot is ``{model_dir}/cgan/snapshot_last.pth``); the flags the
DCGAN trainer does not support exit 1. A ``torchrun`` launch trains
across ranks as the DCGAN trainer does::

    torchrun --nproc-per-node 8 -m xgan_torch.cli.train_cgan --data-dir DIR

(``--batch-size`` the global batch, ``--shard-store`` splitting the store,
every rank reading the same ``--vgg-path``, rank 0 writing every file;
``--steps-per-call`` above 1 exits 1 on a gloo group on the cards).
``--model-parallel N`` with N > 1 dividing the ranks is tensor
parallelism on the JAX CLI's ``(data, model)`` mesh, as in the DCGAN
trainer: G's and D's wide layers split their output channels over each
group of N ranks (``xgan_torch.models.cgan``), and the VGG16 features stay
whole on every rank.
"""
from __future__ import annotations

import argparse

from xgan_torch import config
from xgan_torch.cli import train_gan

def build_parser():
    p = argparse.ArgumentParser(
        description="Train conditional DCGAN on RSNA Pneumonia Dataset "
                    "(PyTorch/CUDA)")
    config.add_path_args(p)
    config.add_gan_model_args(p, fm_default=32)
    config.add_gan_train_args(p, epochs=50, batch_size=32,
                              vis_batch_size=32, save_interval=1000,
                              checkpoint_interval=5)
    p.add_argument("--vgg-path", type=str, default="",
                   help="Optional torchvision vgg16 .pth for the "
                        "perceptual loss")
    train_gan.add_run_args(p)
    return p


def main(argv=None):
    """Train; returns the history (None after a printed error)."""
    args = build_parser().parse_args(argv)
    mesh, dtype = train_gan.start(args)
    from xgan_torch.parallel.mesh import shutdown
    from xgan_torch.train.cgan_loop import train_cgan
    try:
        return train_cgan(args, mesh.device, dtype, mesh)
    finally:
        shutdown(mesh)


if __name__ == "__main__":
    main()
