"""Export a trained model as a self-contained serving artifact (flags as
src/export_model.py).

    python -m xgan_torch.cli.export_model --kind {classifier,gan,wgan,cgan} \
        --model-path M.{msgpack,pth} --output M.pt2 [--quantize int8] ...

The artifact is a ``torch.export`` program behind the JAX package's
self-description envelope (``xgan_torch.io_.export``): weights inside,
batch dimension symbolic, run with no model code::

    from xgan_torch.io_.export import load_exported
    labels, probs = load_exported("clf.pt2", "cuda").call(u8_images)

It runs on the kind of device it was exported on: export on the card to
serve on the card (a program exported with ``--cpu`` holds the plain
versions of the kernels and is refused there). ``--model-path`` takes the
JAX package's ``.msgpack`` checkpoints or reference-layout ``.pth`` state
dicts. After exporting, the artifact is reloaded and checked against the
live model on a random batch (``--skip-verify`` skips that), at the JAX
package's tolerances. Runs on the CUDA device unless ``--cpu`` is given;
without a CUDA device it exits 1 with a structured ``Error:`` line.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from xgan_torch import config


def build_parser():
    p = argparse.ArgumentParser(
        description="Export a trained xgan model as a self-contained "
                    "torch.export artifact for serving (PyTorch/CUDA)")
    p.add_argument("--kind", type=str, required=True,
                   choices=["classifier", "gan", "cgan", "wgan"])
    p.add_argument("--model-path", type=str, required=True,
                   help="checkpoint: .msgpack (the JAX package's) or "
                        "torchvision/reference-layout .pth")
    p.add_argument("--output", type=str, required=True,
                   help="artifact path, e.g. model.pt2")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--latent-dim", type=int, default=100)
    p.add_argument("--feature-maps-g", type=int, default=None,
                   help="generator width; defaults to the per-family "
                        "training default (32 for cgan, 64 otherwise)")
    p.add_argument("--num-classes", type=int, default=2)
    p.add_argument("--quantize", type=str, default="none",
                   choices=["none", "int8"],
                   help="weight-only quantization of conv/dense kernels "
                        "kept in the artifact (per-output-channel "
                        "symmetric int8, dequantized in the program): ~4x "
                        "smaller artifact, compute dtype unchanged")
    p.add_argument("--skip-verify", action="store_true",
                   help="skip the reload + numeric check after export")
    config.add_device_arg(p)
    config.add_compute_dtype_arg(p)  # baked into the artifact
    config.add_resnet_stages_arg(p)
    return p


def load_model(args, device, dtype):
    """The live model of ``args.kind`` with its checkpoint, in eval mode;
    exits 1 with a structured error when it does not load."""
    if args.kind == "classifier":
        from xgan_torch.io_.checkpoint import load_classifier_variables
        from xgan_torch.models.resnet import ResNet50
        if not os.path.exists(args.model_path):
            print(f"Error: model checkpoint not found at {args.model_path}")
            sys.exit(1)
        model = ResNet50(args.num_classes, stage_sizes=args.resnet_stages,
                         dtype=dtype, device=device)
        try:
            load_classifier_variables(args.model_path, model)
        except Exception as e:  # noqa: BLE001 — structured CLI error
            print(f"Error loading classifier checkpoint: {e}")
            sys.exit(1)
        return model.eval()
    if args.kind == "gan":
        from xgan_torch.models.dcgan import Generator
    elif args.kind == "wgan":
        from xgan_torch.models.wgan import Generator
    else:
        from xgan_torch.models.cgan import Generator
    from xgan_torch.train.sample import load_generator
    fm = args.feature_maps_g
    if fm is None:  # each family's training/sampler default
        fm = 32 if args.kind == "cgan" else 64
    kw = {"num_classes": args.num_classes} if args.kind == "cgan" else {}
    model = Generator(latent_dim=args.latent_dim, feature_maps=fm,
                      image_size=args.image_size, dtype=dtype,
                      device=device, **kw)
    return load_generator(model, args.model_path).eval()


def artifact_meta(args, dtype) -> dict:
    """The envelope's header: the JAX package's keys and values."""
    from xgan_torch.io_.export import dtype_name
    conditional = args.kind == "cgan"
    meta = {"kind": args.kind, "image_size": args.image_size,
            "compute_dtype": dtype_name(dtype)}
    if args.quantize != "none":
        meta["quantize"] = args.quantize
    if args.kind == "classifier":
        meta["num_classes"] = args.num_classes
    else:
        meta.update(latent_dim=args.latent_dim, conditional=conditional)
        if conditional:
            meta["num_classes"] = args.num_classes
    return meta


def verify(args, program, device, dtype) -> bool:
    """The reloaded artifact against the live program (the same,
    possibly quantized, weights) on a random batch: classifier
    probabilities within 1e-5 (f32) or 2e-2 (bf16), generator uint8
    images within 0 (f32) or 1 (bf16) levels."""
    import numpy as np
    import torch

    from xgan_torch.io_.export import load_exported
    art = load_exported(args.output, device)
    rng = np.random.default_rng(0)
    f32 = dtype == torch.float32
    if args.kind == "classifier":
        x = torch.from_numpy(rng.integers(
            0, 255, (2, args.image_size, args.image_size, 3),
            np.uint8)).to(device)
        with torch.no_grad():
            want = program(x)[1]
        got = art.call(x)[1]
        return bool(torch.allclose(got, want, rtol=0,
                                   atol=1e-5 if f32 else 2e-2))
    z = torch.from_numpy(rng.normal(size=(2, args.latent_dim))
                         .astype(np.float32)).to(device)
    inputs = (z,)
    if args.kind == "cgan":
        inputs += (torch.from_numpy(rng.integers(
            0, args.num_classes, (2,), np.int32)).to(device),)
    with torch.no_grad():
        want = program(*inputs)
    got = art.call(*inputs)
    diff = (got.short() - want.short()).abs().max().item()
    return diff <= (0 if f32 else 1)


def main(argv=None) -> dict:
    """Export (and verify); returns ``{"bytes", "export_s", "verified"}``."""
    args = build_parser().parse_args(argv)
    try:
        device = config.resolve_device(args.cpu)
    except RuntimeError as e:
        print(f"Error: {e}")
        sys.exit(1)
    if args.output.endswith(".stablehlo"):
        print("Error: xgan_torch writes .pt2 artifacts (a torch.export "
              "program); .stablehlo needs JAX")
        sys.exit(1)
    from xgan_torch.io_.export import (build_program, example_inputs,
                                       export_program, save_exported)
    dtype = config.resolve_dtype(args.compute_dtype, device)
    model = load_model(args, device, dtype)
    t0 = time.perf_counter()
    program = build_program(args.kind, model, quantize=args.quantize)
    ep = export_program(program, example_inputs(
        args.kind, image_size=args.image_size, latent_dim=args.latent_dim,
        device=device))
    nbytes = save_exported(args.output, ep, artifact_meta(args, dtype))
    stats = {"bytes": nbytes, "export_s": time.perf_counter() - t0,
             "verified": None}
    print(f"Exported {args.kind} -> {args.output} ({nbytes / 1e6:.1f} MB, "
          f"{device.type} program, symbolic batch, self-describing "
          "envelope)")
    if args.skip_verify:
        return stats
    stats["verified"] = verify(args, program, device, dtype)
    if not stats["verified"]:
        print("Error: exported artifact disagrees with the live model")
        sys.exit(1)
    print("Verified: artifact output matches the live model.")
    return stats


if __name__ == "__main__":
    main()
