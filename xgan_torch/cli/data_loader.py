"""Data-layer self-test (flags and printed lines as src/data_loader.py).

    python -m xgan_torch.cli.data_loader --data-dir DIR \
        [--test-mode basic|kfold|augmented|kfold_augmented|phased_kfold] ...

Checks the RSNA-layout dataset tree, builds the port's image store, and
runs one batch source per ``--test-mode`` on the device: a real batch, the
k-fold split (the reference's ``KFold`` seed), the concatenated
real + synthetic space (``gather_concat``), or the curriculum mixer at
ratios 0, 0.5 and 1 (``mix_batch``; on the card one ``mixed_gather``
launch each). Each batch prints its normalized shape and dtype, its labels
and their distribution. This is the check to run on the GPU host before a
training run. The mixer's draws come from a ``torch.Generator`` seeded 0
for each ratio (the JAX package draws from ``jax.random.key(0)``), so the
labels at ratio 0.5 differ from the JAX package's. Runs on the CUDA device
unless ``--cpu`` is given; without a CUDA device it exits 1 with a
structured ``Error:`` line.
"""
from __future__ import annotations

import argparse
import sys

from xgan_torch import config

STORE_WORKERS = 4  # the store's decode threads


def build_parser():
    p = argparse.ArgumentParser(
        description="Test the PyTorch/CUDA data pipeline on an RSNA-layout "
                    "dataset")
    p.add_argument("--data-dir", type=str, default="./data/processed")
    p.add_argument("--synthetic-dir", type=str, default="./data/synthetic")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--k-folds", type=int, default=3)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--cache-dir", type=str, default="./data/cache")
    p.add_argument("--test-mode", type=str,
                   choices=["basic", "kfold", "augmented",
                            "kfold_augmented", "phased_kfold"],
                   default="basic")
    config.add_device_arg(p)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    try:
        device = config.resolve_device(args.cpu)
    except RuntimeError as e:
        print(f"Error: {e}")
        sys.exit(1)

    import numpy as np

    from xgan_torch.data import rsna
    from xgan_torch.data.pipeline import DeviceStore, normalize_images
    from xgan_torch.io_.export import dtype_name
    from xgan_torch.train.gan_loop import load_train_store

    print("\n--- Checking dataset availability ---")
    if not rsna.check_dataset_availability(args.data_dir):
        print("Please download the dataset first using "
              "src/download_dataset.py.")
        return

    args.workers = STORE_WORKERS
    real = DeviceStore(load_train_store(args, device), device)
    rng = np.random.default_rng(0)

    def show_batch(name, imgs_u8, labs):
        normed = normalize_images(imgs_u8)
        labs = labs.cpu().numpy()
        counts = np.bincount(labs, minlength=2)
        print(f"{name}: images {tuple(normed.shape)} "
              f"{dtype_name(normed.dtype)}, labels {labs.tolist()}, "
              f"label distribution {counts.tolist()}")

    # the reference's self-test contract: an error in the exercised
    # source prints the error and its traceback, and the run finishes
    mode = args.test_mode
    try:
        run_mode(args, mode, real, rng, show_batch, device)
    except Exception as e:  # noqa: BLE001 — reference self-test contract
        import traceback
        print(f"Error using {mode}: {e}")
        traceback.print_exc()

    print("\nData pipeline self-test finished.")


def run_mode(args, mode, real, rng, show_batch, device):
    """One ``--test-mode``'s batches over the device store ``real``."""
    import numpy as np
    import torch

    from xgan_torch.data.mixer import mix_batch
    from xgan_torch.data.pipeline import DeviceStore, epoch_batches, take_rows
    from xgan_torch.data.store import decode_folder_store
    from xgan_torch.train.classifier import gather_concat
    from xgan_torch.train.classifier_loop import kfold_splits

    def on_device(idx):
        return torch.from_numpy(np.asarray(idx, np.int64)).to(device)

    n = len(real)
    if mode in ("basic", "kfold"):
        if mode == "basic":
            batch = on_device(epoch_batches(n, args.batch_size, rng)[0])
            show_batch("basic train batch", take_rows(real.images, batch),
                       real.labels[batch])
        else:
            for fold, (tr, va) in enumerate(kfold_splits(n, args.k_folds)):
                print(f"Fold {fold + 1}/{args.k_folds}: train {len(tr)}, "
                      f"val {len(va)}")
            batch = on_device(epoch_batches(len(tr), args.batch_size, rng,
                                            indices=tr)[0])
            show_batch("fold train batch", take_rows(real.images, batch),
                       real.labels[batch])
        return
    synth = DeviceStore(decode_folder_store(
        args.synthetic_dir, args.image_size, cache_dir=args.cache_dir,
        workers=args.workers, compiled=device.type == "cuda"), device)
    if mode in ("augmented", "kfold_augmented"):
        if mode == "kfold_augmented":
            for fold, (tr, va) in enumerate(kfold_splits(n, args.k_folds)):
                print(f"Fold {fold + 1} - Train size: "
                      f"{len(tr) + len(synth)} (Original: {len(tr)}, "
                      f"Synthetic: {len(synth)}), Val size: {len(va)}")
            space = np.concatenate([tr, n + np.arange(len(synth))])
        else:
            space = np.concatenate([np.arange(n), n + np.arange(len(synth))])
        batch = on_device(epoch_batches(len(space), args.batch_size, rng,
                                        indices=space)[0])
        imgs, labs = gather_concat(real.images, real.labels, synth.images,
                                   synth.labels, batch, n_real=n)
        show_batch(f"{mode} batch (concat space "
                   f"{len(space) - len(synth)}+{len(synth)})", imgs, labs)
        return
    for ratio in (0.0, 0.5, 1.0):  # phased_kfold
        batch = on_device(epoch_batches(n, args.batch_size, rng)[0])
        imgs, labs = mix_batch(
            real.images, real.labels, batch, synth.images, synth.labels,
            ratio, generator=torch.Generator(device).manual_seed(0))
        show_batch(f"phased batch ratio={ratio}", imgs, labs)


if __name__ == "__main__":
    main()
