"""Synthetic-image generation (role of xgan/train/sample.py).

Samples the eval-mode generator (the conditional one with a label per
image) batch by batch on the device, converts
to uint8 there (the reference's ``x*0.5+0.5`` export transform) and
writes ``synthetic_00001.png`` ... on the host. The device work of batch
k+1 is enqueued before the PNG encode of batch k, so the two overlap.
"""
from __future__ import annotations

import os
import pickle
import sys
import time

import numpy as np
import torch

from xgan_torch.data.pipeline import tanh_to_u8
from xgan_torch.io_.checkpoint import load_flax_checkpoint
from xgan_torch.io_.export import Artifact, load_exported_with_meta
from xgan_torch.models.convert import load_generator_pth
from xgan_torch.native.png import encode_png_batch
from xgan_torch.utils import StepTimer, check_create_dir


def load_generator(model, path: str):
    """Load a generator checkpoint into ``model`` (strictly): a
    ``.msgpack`` the JAX package wrote (through its flax layout, with its
    per-leaf shape check) or a reference-layout ``.pth``.

    Structured-error exit 1 when the file is missing or does not match
    the model flags, like the JAX sampler."""
    if not os.path.exists(path):
        print(f"Error: Generator model not found at {path}")
        sys.exit(1)
    try:
        if path.endswith(".msgpack"):
            load_flax_checkpoint(model, path, f"checkpoint {path} does not "
                                 "match the model flags")
        else:
            model.load_state_dict(load_generator_pth(path), strict=True)
    except (RuntimeError, ValueError, KeyError, OSError,
            pickle.UnpicklingError) as e:
        print(f"Error loading generator checkpoint: {e}")
        print("Ensure the model flags (--latent-dim/--feature-maps-g/"
              "--image-size) match training.")
        sys.exit(1)
    return model


def load_generator_artifact(path: str, *, conditional: bool,
                            device: torch.device):
    """Load a ``.pt2`` generator artifact (``xgan_torch.cli.export_model``)
    for sampling on ``device``; returns ``(artifact, latent_dim, meta)``
    with ``meta`` the envelope (``{}`` without one). Structured-error exit
    1 when it is missing, was exported on another kind of device, or is
    not a generator of the expected conditionality."""
    if not os.path.exists(path):
        print(f"Error: Generator model not found at {path}")
        sys.exit(1)
    try:
        art, meta = load_exported_with_meta(path, device)
        ins = art.inputs
        ok = (len(ins) in (1, 2) and len(ins[0][0]) == 2
              and ins[0][1] == torch.float32)
        if not ok:
            raise ValueError(
                "not a generator artifact: expected float32 (b, latent) "
                f"[+ int32 labels] inputs, got {ins}")
        if (len(ins) == 2) != conditional:
            want = "conditional" if conditional else "unconditional"
            have = "conditional" if len(ins) == 2 else "unconditional"
            raise ValueError(f"this sampler needs a {want} generator "
                             f"artifact; {path} is {have}")
    except (OSError, RuntimeError, ValueError) as e:
        print(f"Error loading generator artifact: {e}")
        sys.exit(1)
    return art, int(ins[0][0][1]), meta or {}


def generate_images(model, *, output_dir: str, num_images: int,
                    latent_dim: int, batch_size: int, seed: int = 0,
                    device: torch.device | str = "cuda",
                    dtype: torch.dtype = torch.bfloat16, noise=None,
                    conditional: bool = False, labels=None,
                    num_classes: int = 2,
                    stats: dict | None = None) -> int:
    """Sample ``num_images`` and write PNGs; returns the count written.

    ``z`` is drawn from ``torch.Generator(device).manual_seed(seed)``
    unless ``noise`` (an iterable of (B, latent) arrays) is given. A
    ``conditional`` model is called as ``model(z, labels)``: each batch
    draws its z, then its labels uniform over ``model.num_classes`` from
    the same generator, unless ``labels`` (an iterable of (B,) int arrays)
    is given. ``model`` may be a generator ``Artifact`` (its program
    renders uint8 images; labels are drawn over ``num_classes``). Never
    more than ``num_images`` files are written, named
    ``synthetic_00001.png`` ....
    ``stats`` receives
    ``imgs_per_sec`` (all images over the whole loop, writes included) and
    ``device_plus_transfer_imgs_per_sec`` (the JAX sampler's rate: the loop
    up to the last batch's arrival on the host, with the overlapped
    encode of the batch before it)."""
    device = torch.device(device)
    check_create_dir(output_dir)
    if isinstance(model, Artifact):
        def render(z, y=None):  # its labels input is int32
            return model.call(z) if y is None else model.call(
                z, y.to(torch.int32))
    else:
        model.to(device)
        model.set_compute_dtype(dtype)
        num_classes = model.num_classes if conditional else num_classes

        def render(*inputs):
            return tanh_to_u8(model(*inputs))
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = iter(noise) if noise is not None else None
    label_draws = iter(labels) if labels is not None else None

    def injected(it, what, dtype):
        x = next(it, None)
        if x is None:
            raise ValueError(f"{what} ran out before {num_images} images")
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    def next_batch():
        if draws is None:
            z = torch.randn((batch_size, latent_dim), generator=gen,
                            device=device)
        else:
            z = injected(draws, "noise", np.float32)
        if not conditional:
            return render(z)
        if label_draws is None:
            y = torch.randint(0, num_classes, (z.shape[0],),
                              generator=gen, device=device)
        else:
            y = injected(label_draws, "labels", np.int64)
        return render(z, y)

    print(f"Generating {num_images} synthetic images (batch {batch_size}, "
          f"{device}, {dtype})...")
    t0 = time.perf_counter()
    timer = StepTimer(device)
    written = sampled = 0
    pending = None  # host copy of the previous batch, encoded meanwhile
    while written < num_images:
        imgs_dev = None
        if sampled < num_images:
            imgs_dev = next_batch()
            sampled += imgs_dev.shape[0]
        if pending is not None:
            written = _write_pngs(pending, output_dir, written, num_images)
        if imgs_dev is not None:
            pending = imgs_dev.cpu().numpy()
            timer.tick(pending.shape[0])
        else:
            pending = None
    rate = written / (time.perf_counter() - t0)
    print(f"Finished generating {written} images in {output_dir} "
          f"({rate:.1f} imgs/s written, {timer.rate:.1f} imgs/s "
          "device+transfer)")
    if stats is not None:
        stats["imgs_per_sec"] = rate
        stats["device_plus_transfer_imgs_per_sec"] = timer.rate
    return written


def _write_pngs(images: np.ndarray, output_dir: str, written: int,
                num_images: int) -> int:
    take = min(images.shape[0], num_images - written)
    paths = [os.path.join(output_dir,
                          f"synthetic_{written + i + 1:05d}.png")
             for i in range(take)]
    failures = encode_png_batch(images[:take], paths)
    if failures:
        print(f"Warning: {failures} PNG writes failed")
    written += take
    if written % 1000 < take:
        print(f"Generated {written}/{num_images} images...")
    return written
