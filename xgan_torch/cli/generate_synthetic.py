"""Generate synthetic images from a trained DCGAN generator on the GPU
(flags and defaults as src/generate_synthetic.py).

    python -m xgan_torch.cli.generate_synthetic --model-path G.pth \
        [--output-dir ./data/synthetic] [--num-images 5000] [--cpu] ...

Reads the JAX package's ``.msgpack`` generator checkpoints,
reference-layout ``.pth``/``.pt`` ones and the port's ``.pt2`` generator
artifacts (``xgan_torch.cli.export_model``; the latent size comes from the
artifact, which must be of this sampler's conditionality). ``.stablehlo``
artifacts need JAX and exit 1 with a structured ``Error:`` line. Runs on
the CUDA device unless ``--cpu`` is given; without a CUDA device it exits
1 with a structured ``Error:`` line instead of continuing on the CPU.

Under a ``torchrun`` launch (as the trainers take one) the ranks share
the work: the batch is ``--batch-size`` rounded up to a multiple of the
ranks, every rank draws the same ``z`` (and labels) from ``--seed`` and
renders and writes its rows of each batch under their global names::

    torchrun --nproc-per-node 8 -m xgan_torch.cli.generate_synthetic \
        --model-path G.pth --num-images 5000

A ``.pt2`` artifact exits 1 under a launch.
"""
from __future__ import annotations

import argparse
import sys

from xgan_torch import config

UNSUPPORTED = (".stablehlo",)


def build_parser(description: str = "Generate synthetic images using a "
                                    "trained DCGAN generator "
                                    "(PyTorch/CUDA).", fm_default: int = 64):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--model-path", type=str, required=True,
                   help="Trained generator: a .msgpack checkpoint of the "
                        "JAX package, a reference-layout torch .pth/.pt, or "
                        "a .pt2 artifact of xgan_torch.cli.export_model")
    p.add_argument("--output-dir", type=str, default="./data/synthetic")
    p.add_argument("--num-images", type=int, default=5000)
    p.add_argument("--latent-dim", type=int, default=100)
    p.add_argument("--feature-maps-g", type=int, default=fm_default)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--seed", type=int, default=0)
    config.add_device_arg(p)
    config.add_compute_dtype_arg(p)
    return p


def main(argv=None) -> dict:
    """Run the sampler; returns its stats (``written``, ``imgs_per_sec``,
    ``device_plus_transfer_imgs_per_sec``)."""
    from xgan_torch.models.dcgan import Generator
    return sample(build_parser().parse_args(argv), Generator)


def sample(args, generator_cls, conditional: bool = False) -> dict:
    """The sampler on a ``generator_cls`` generator (the DCGAN, WGAN-GP or,
    with ``conditional``, the 2-class CGAN one) with the parsed flags;
    returns its stats as :func:`main`."""
    from xgan_torch.io_.export import EXT
    from xgan_torch.parallel.mesh import launched, shutdown
    if args.model_path.endswith(EXT) and launched():
        print(f"Error: a {EXT} generator artifact is not supported by "
              f"xgan_torch yet{config.UNDER_LAUNCH}; sample it as one "
              "process, or pass its .pth or .msgpack checkpoint")
        sys.exit(1)
    mesh = config.join_ranks(args)
    try:
        return _sample(args, generator_cls, conditional, mesh)
    finally:
        shutdown(mesh)


def _sample(args, generator_cls, conditional: bool, mesh) -> dict:
    device = mesh.device
    if args.model_path.endswith(UNSUPPORTED):
        print(f"Error: {args.model_path}: .stablehlo artifacts are not "
              "supported by xgan_torch (they need JAX); export a .pt2 "
              "with python -m xgan_torch.cli.export_model, or pass a "
              ".msgpack or .pth checkpoint")
        sys.exit(1)
    dtype = config.resolve_dtype(args.compute_dtype, device)
    from xgan_torch.io_.export import EXT
    from xgan_torch.train.sample import (generate_images, load_generator,
                                         load_generator_artifact)

    latent, num_classes = args.latent_dim, 2
    if args.model_path.endswith(EXT):
        model, latent, meta = load_generator_artifact(
            args.model_path, conditional=conditional, device=device)
        num_classes = meta.get("num_classes", num_classes)
    else:
        model = generator_cls(latent_dim=args.latent_dim,
                              feature_maps=args.feature_maps_g,
                              image_size=args.image_size, dtype=dtype,
                              device=device)
        load_generator(model, args.model_path)
    stats = {}
    stats["written"] = generate_images(
        model, output_dir=args.output_dir, num_images=args.num_images,
        latent_dim=latent, batch_size=args.batch_size,
        seed=args.seed, device=device, dtype=dtype,
        conditional=conditional, num_classes=num_classes, stats=stats,
        mesh=mesh)
    return stats


if __name__ == "__main__":
    main()
