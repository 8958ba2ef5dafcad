"""Generate synthetic images from a trained conditional GAN generator on
the GPU (flags and defaults as src/generate_synthetic_cgan.py).

    python -m xgan_torch.cli.generate_synthetic_cgan --model-path G.pth \
        [--output-dir ./data/synthetic] [--num-images 5000] [--cpu] ...

The DCGAN sampler (``xgan_torch.cli.generate_synthetic``) on the CGAN
generator (``xgan_torch.models.cgan.Generator``, 2 classes): each batch
draws z and then its labels, uniform over the classes, from the seeded
generator (the reference samples labels at random). The same
checkpoint and artifact formats (``.msgpack``, ``.pth``, ``.pt2``; an
artifact's classes come from its envelope), PNG names and structured
refusals (``.stablehlo`` exits 1, as does a missing CUDA device without
``--cpu``).
"""
from __future__ import annotations

from xgan_torch.cli import generate_synthetic


def build_parser():
    return generate_synthetic.build_parser(
        "Generate synthetic images using a trained conditional GAN "
        "generator (PyTorch/CUDA).", fm_default=32)


def main(argv=None) -> dict:
    """Run the sampler; returns its stats as
    ``xgan_torch.cli.generate_synthetic.main`` does."""
    from xgan_torch.models.cgan import Generator
    return generate_synthetic.sample(build_parser().parse_args(argv),
                                     Generator, conditional=True)


if __name__ == "__main__":
    main()
