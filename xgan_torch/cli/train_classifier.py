"""Train the ResNet-50 pneumonia classifier on the GPU
(flags and defaults as src/train_classifier.py).

    python -m xgan_torch.cli.train_classifier --data-dir DIR \
        [--use-synthetic [--use-curriculum]] [--k-folds 5] [--cpu] ...

Strategies baseline, augmented (--use-synthetic) and curriculum (with
--use-curriculum), each with k-fold CV or one run on the test split.
Runs on the CUDA device unless ``--cpu`` is given; without a CUDA device
it exits 1 with a structured ``Error:`` line. ``--grad-accum A`` splits
each step into A microbatches, ``--remat`` recomputes ResNet activations
in the backward (``--remat-scope block|stage|nested``), ``--trace-dir``
writes a profiler trace of one train epoch per run, and with k-fold CV
``--resume-from auto`` loads the folds a stopped run completed (a first
SIGTERM or SIGINT stops the run at the end of its epoch), while
``--parallel-folds`` trains the k folds in lockstep, one step advancing
all of them (``xgan_torch.train.parallel_cv``). ``--model-parallel N``
trains replicated after the JAX CLI's note when N does not divide the
ranks (1 without a launch).

Data parallelism (the JAX CLI's default over every local device) is a
``torchrun`` launch here, one process a card::

    torchrun --nproc-per-node 8 -m xgan_torch.cli.train_classifier ...

``--batch-size`` is then the global batch (rounded up to a multiple of
the ranks); every fold trains on all ranks, rank 0 writes every file, and
``--shard-store`` splits the real and test stores over the ranks.
``--grad-accum``, ``--remat`` and ``--shard-opt-state`` (ZeRO-1 Adam
moments) run there too. ``--parallel-folds`` splits the ranks into
gcd(k, ranks) fold groups, each training k / gcd folds on its ranks
(``xgan_torch.train.parallel_cv``); ``--shard-store``,
``--shard-opt-state`` and ``--model-parallel`` are ignored there, each
with the JAX CLI's note. ``--model-parallel N`` with N > 1 dividing the
ranks is tensor parallelism on the JAX CLI's ``(data, model)`` mesh: each
group of N ranks splits ResNet-50's wide layers' output channels
(``fc`` row-parallel; ``xgan_torch.parallel.tp``) and sees the same rows;
``--shard-store`` and ``--shard-opt-state`` then split over the data
ranks.
"""
from __future__ import annotations

import argparse
import sys

import torch

from xgan_torch import config


def build_parser():
    p = argparse.ArgumentParser(
        description="Train ResNet50 Classifier for Pneumonia Detection "
                    "(PyTorch/CUDA)")
    config.add_path_args(p)
    p.add_argument("--synthetic-dir", type=str, default="./data/synthetic",
                   help="Directory containing synthetic images")
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--unfreeze", action="store_true",
                   help="Unfreeze base ResNet layers for fine-tuning")
    p.add_argument("--k-folds", type=int, default=5,
                   help="Folds for cross-validation; 1 = single split")
    p.add_argument("--workers", type=int, default=4,
                   help="Host threads that decode the images for the "
                        "one-time store build")
    p.add_argument("--use-synthetic", action="store_true",
                   help="Use synthetic data augmentation")
    p.add_argument("--use-curriculum", action="store_true",
                   help="Phased curriculum (requires --use-synthetic)")
    p.add_argument("--curriculum-schedule", type=str,
                   default="0:0.0, 5:0.25, 10:0.5",
                   help='Schedule "epoch1:ratio1,epoch2:ratio2,..."')
    p.add_argument("--pretrained-path", type=str, default="",
                   help="Optional torchvision resnet50 .pth for ImageNet "
                        "init (no network access is assumed)")
    p.add_argument("--image-size", type=int, default=224,
                   help="Image size (224 = reference)")
    p.add_argument("--seed", type=int, default=0)
    config.add_compute_dtype_arg(p)
    p.add_argument("--cache-dir", type=str, default="./data/cache")
    p.add_argument("--limit-batches", type=int, default=0,
                   help="Debug: cap batches per epoch (0 = all)")
    config.add_device_arg(p)
    config.add_resnet_stages_arg(p)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="(JAX GAN trainers only; ignored here)")
    p.add_argument("--remat", action="store_true",
                   help="Recompute ResNet activations in the backward "
                        "(torch.utils.checkpoint) instead of keeping "
                        "them: less activation memory, about one more "
                        "forward of compute; same results")
    p.add_argument("--remat-scope", default="block",
                   choices=["block", "stage", "nested"],
                   help="What --remat checkpoints: each bottleneck block, "
                        "each of the four stages, or each stage with its "
                        "blocks checkpointed inside the recompute")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="Split every step into K sequential microbatches: "
                        "gradients accumulate, one optimizer update fires "
                        "per step, only one microbatch's activations are "
                        "live. BN batch statistics are per-microbatch "
                        "(torch accumulation semantics). Must divide the "
                        "batch size.")
    p.add_argument("--trace-dir", type=str, default="",
                   help="Write a torch.profiler trace of one train epoch "
                        "(of every run) here")
    p.add_argument("--resume-from", type=str, default="",
                   help="'auto': k-fold CV loads the folds a stopped run "
                        "completed (their history and best checkpoint) "
                        "and trains the rest")
    p.add_argument("--parallel-folds", action="store_true",
                   help="k-fold CV: train every fold at once in lockstep "
                        "(stacked models, one step per batch for all "
                        "folds); the same artifacts as the sequential "
                        "path")
    config.add_shard_args(p)
    return p


def main(argv=None):
    """Run the classifier; returns the CV summary or the single run's
    metrics (None after a printed error)."""
    args = build_parser().parse_args(argv)
    if args.k_folds < 1:
        print("Error: k-folds must be at least 1.")
        sys.exit(1)
    mesh = config.join_ranks(args, parallel_folds=args.parallel_folds)
    device = mesh.device
    if args.use_curriculum and not args.use_synthetic:
        print("Warning: --use-curriculum requires --use-synthetic. "
              "Ignoring curriculum schedule.")
        args.use_curriculum = False
    if args.steps_per_call > 1:
        print("Note: --steps-per-call applies to the GAN trainers; "
              "ignored for classifier training.")
    dtype = config.resolve_dtype(args.compute_dtype, device)
    if device.type == "cuda" and dtype == torch.float32:
        # f32 means f32: cuDNN would otherwise run the convolutions in TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    print("--- Training Arguments ---")
    for k, v in sorted(vars(args).items()):
        print(f"  {k}: {v}")
    print("-------------------------")
    from xgan_torch.parallel.mesh import shutdown
    from xgan_torch.train.classifier_loop import train_classifier
    try:
        return train_classifier(args, device, dtype, mesh)
    finally:
        shutdown(mesh)


if __name__ == "__main__":
    main()
