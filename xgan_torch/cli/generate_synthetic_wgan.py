"""Generate synthetic images from a trained WGAN-GP generator on the GPU
(flags and defaults as src/generate_synthetic_wgan.py).

    python -m xgan_torch.cli.generate_synthetic_wgan --model-path G.pth \
        [--output-dir ./data/synthetic] [--num-images 5000] [--cpu] ...

The DCGAN sampler (``xgan_torch.cli.generate_synthetic``) on the WGAN-GP
generator (``xgan_torch.models.wgan.Generator``): the same checkpoint and
artifact formats (``.msgpack``, ``.pth``, ``.pt2``), PNG names and
structured refusals (``.stablehlo`` exits 1, as does a missing CUDA device
without ``--cpu``).
"""
from __future__ import annotations

from xgan_torch.cli import generate_synthetic


def build_parser():
    return generate_synthetic.build_parser(
        "Generate synthetic images using a trained WGAN-GP generator "
        "(PyTorch/CUDA).")


def main(argv=None) -> dict:
    """Run the sampler; returns its stats as
    ``xgan_torch.cli.generate_synthetic.main`` does."""
    from xgan_torch.models.wgan import Generator
    return generate_synthetic.sample(build_parser().parse_args(argv),
                                     Generator)


if __name__ == "__main__":
    main()
