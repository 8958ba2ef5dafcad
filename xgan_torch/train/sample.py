"""Synthetic-image generation (role of xgan/train/sample.py).

Samples the eval-mode generator (the conditional one with a label per
image) batch by batch on the device, converts
to uint8 there (the reference's ``x*0.5+0.5`` export transform) and
writes ``synthetic_00001.png`` ... on the host. The device work of batch
k+1 is enqueued before the PNG encode of batch k, so the two overlap.
Under a ``torchrun`` launch each rank renders and writes its rows of
every batch (``generate_images(mesh=...)``).
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
                    stats: dict | None = None, mesh=None) -> int:
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
    encode of the batch before it).

    ``mesh`` (a joined process group): the batch is ``batch_size``
    rounded up to a multiple of the ranks (``pad_batch``, as the JAX
    sampler shards ``z`` over ``data``); every rank draws the whole
    batch's z and labels from the same seed, renders its
    ``local_rows`` and writes those rows' PNGs under their global names,
    so the ranks write the files one process writes at that batch and
    share the PNG encode. A barrier ends the loop; rank 0 prints the
    totals, and every rank returns the global count."""
    device = torch.device(device)
    dp = mesh is not None and mesh.distributed
    main = not dp or mesh.is_main
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
    batch = mesh.pad_batch(batch_size) if dp else batch_size

    def injected(it, what, dtype):
        x = next(it, None)
        if x is None:
            raise ValueError(f"{what} ran out before {num_images} images")
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    def next_batch():
        """(this rank's rows rendered, the batch's rows, the first row's
        place in it)."""
        if draws is None:
            z = torch.randn((batch, latent_dim), generator=gen,
                            device=device)
        else:
            z = injected(draws, "noise", np.float32)
        rows = mesh.local_rows(z.shape[0]) if dp else slice(0, None)
        if not conditional:
            return render(z[rows]), z.shape[0], rows.start
        if label_draws is None:
            y = torch.randint(0, num_classes, (z.shape[0],),
                              generator=gen, device=device)
        else:
            y = injected(label_draws, "labels", np.int64)
        return render(z[rows], y[rows]), z.shape[0], rows.start

    if main:
        print(f"Generating {num_images} synthetic images (batch {batch}, "
              f"{device}, {dtype}"
              + (f", {mesh.world} ranks" if dp else "") + ")...")
    t0 = time.perf_counter()
    timer = StepTimer(device)
    written = sampled = 0
    pending = None  # host copy of the previous batch, encoded meanwhile
    while written < num_images:
        nxt = None
        if sampled < num_images:
            nxt = next_batch()
            sampled += nxt[1]
        if pending is not None:
            imgs, n, first = pending
            _write_pngs(imgs, output_dir, written + first, num_images)
            done = min(written + n, num_images)
            if main and done // 1000 > written // 1000:
                print(f"Generated {done}/{num_images} images...")
            written = done
        pending = None
        if nxt is not None:
            pending = (nxt[0].cpu().numpy(), *nxt[1:])
            timer.tick(nxt[1])
    if dp:
        mesh.barrier()  # every rank's files are written
    rate = written / (time.perf_counter() - t0)
    if main:
        print(f"Finished generating {written} images in {output_dir} "
              f"({rate:.1f} imgs/s written, {timer.rate:.1f} imgs/s "
              "device+transfer)")
    if stats is not None:
        stats["imgs_per_sec"] = rate
        stats["device_plus_transfer_imgs_per_sec"] = timer.rate
    return written


def _write_pngs(images: np.ndarray, output_dir: str, start: int,
                num_images: int) -> None:
    """Encode ``images``, the rows of a batch from global row ``start``
    on, as ``synthetic_{start + 1:05d}.png`` ..., never a row at or past
    ``num_images``."""
    take = max(0, min(images.shape[0], num_images - start))
    paths = [os.path.join(output_dir, f"synthetic_{start + i + 1:05d}.png")
             for i in range(take)]
    failures = encode_png_batch(images[:take], paths)
    if failures:
        print(f"Warning: {failures} PNG writes failed")
