"""Shared CLI flags and device/dtype resolution (role of xgan/config.py).

``--compute-dtype auto`` is bf16 on CUDA and f32 on the CPU. The device is
CUDA unless ``--cpu`` is given; without a CUDA device and without
``--cpu`` the entry points stop with a structured error instead of
continuing on the CPU.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch


def add_compute_dtype_arg(p: argparse.ArgumentParser):
    p.add_argument("--compute-dtype", type=str, default="auto",
                   choices=["auto", "bf16", "f32"],
                   help="auto: bf16 on CUDA, f32 on CPU")


def add_path_args(p: argparse.ArgumentParser):
    """The reference's path flags, with its defaults."""
    p.add_argument("--data-dir", type=str, default="./data/processed",
                   help="Path to the processed dataset directory")
    p.add_argument("--model-dir", type=str, default="./models",
                   help="Base directory to save model checkpoints")
    p.add_argument("--output-dir", type=str, default="./results",
                   help="Base directory for outputs")
    p.add_argument("--results-dir", type=str, default="./results/metrics",
                   help="Directory to save training history JSON")
    p.add_argument("--figures-dir", type=str, default="./results/figures",
                   help="Directory to save generated plot images")


def add_gan_model_args(p: argparse.ArgumentParser, fm_default: int = 64):
    """The GAN model flags, with the reference's defaults."""
    p.add_argument("--num-channels", type=int, default=3)
    p.add_argument("--latent-dim", type=int, default=100)
    p.add_argument("--feature-maps-g", type=int, default=fm_default)
    p.add_argument("--feature-maps-d", type=int, default=fm_default)


def add_gan_train_args(p: argparse.ArgumentParser, *, epochs: int,
                       batch_size: int, vis_batch_size: int = 64,
                       save_interval: int = 500,
                       checkpoint_interval: int = 10):
    """The GAN training flags, with the JAX package's defaults."""
    p.add_argument("--epochs", type=int, default=epochs)
    p.add_argument("--batch-size", type=int, default=batch_size)
    p.add_argument("--lr", type=float, default=0.0002)
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--workers", type=int, default=4,
                   help="Host threads that decode the images for the "
                        "one-time store build")
    p.add_argument("--vis-batch-size", type=int, default=vis_batch_size)
    p.add_argument("--save-interval", type=int, default=save_interval,
                   help="Iterations between sample sheets")
    p.add_argument("--checkpoint-interval", type=int,
                   default=checkpoint_interval,
                   help="Epochs between checkpoints")
    p.add_argument("--grad-accum", type=int, default=1,
                   help="Split every D and G update into K sequential "
                        "microbatches: gradients accumulate, one "
                        "optimizer update fires per update, and only one "
                        "microbatch's activations are live (~K× "
                        "activation-memory reduction). BN batch "
                        "statistics are per-microbatch (torch "
                        "accumulation semantics). Must divide the batch "
                        "size.")
    p.add_argument("--ema-decay", type=ema_decay, default=0.0,
                   help="Keep an exponential moving average of the "
                        "generator weights (e.g. 0.999) and save it as "
                        "generator_ema_final.pth next to the raw finals "
                        "— the standard GAN sample-quality lever. 0 "
                        "disables (default; training math is identical "
                        "either way)")


def ema_decay(value: str) -> float:
    """Range-checked ``--ema-decay``: the update ``e*d + (1-d)*p``
    diverges for d outside [0, 1), and since nothing in training reads the
    EMA, the run would look healthy until its final EMA checkpoint came
    out inf. Fails the typo at parse time."""
    f = float(value)
    if not 0.0 <= f < 1.0:
        raise argparse.ArgumentTypeError(
            f"--ema-decay must be in [0, 1) (e.g. 0.999); got {value}")
    return f


UNDER_LAUNCH = " under a torchrun launch (RANK, WORLD_SIZE, LOCAL_RANK set)"


def join_ranks(args, *, parallel_folds: bool = False):
    """The run's :class:`~xgan_torch.parallel.MeshContext`
    (``init_from_env``; ``--dist-backend`` picks the backend of a launch).
    Before it joins, ``--model-parallel N`` (a trainer's) against the
    launch's world (1 without one): the JAX package's note when N does not
    divide it (training replicated), and its note under ``parallel_folds``
    (the fold groups own the ranks). When N > 1 divides it, the ranks are
    laid out as the JAX package's ``(data, model)`` mesh
    (``MeshContext.split_model``) and the data group's context, carrying
    its model group, is returned: every trainer takes tensor parallelism.
    Exits 1 with an ``Error:`` line when the device or the process group
    is not there."""
    from xgan_torch.parallel.mesh import init_from_env, launched
    from xgan_torch.parallel.tp import model_parallel_from_args
    world = int(os.environ["WORLD_SIZE"]) if launched() else 1
    n = model_parallel_from_args(args, world)
    if n > 1 and parallel_folds:
        print("Note: --model-parallel is ignored with --parallel-folds "
              "(the fold axis owns the mesh); training with replicated "
              "params.")
        n = 1
    try:
        mesh = init_from_env(args.cpu, getattr(args, "dist_backend", "")
                             or None)
    except (RuntimeError, ValueError) as e:
        print(f"Error: {e}")
        sys.exit(1)
    if n > 1:
        data, model = mesh.split_model(n)
        print(f"Tensor parallelism: mesh {{'data': {world // n}, 'model': "
              f"{n}}}; rank {mesh.rank} is data rank {data.rank}, model "
              f"rank {model.rank}")
        return data
    return mesh


def add_resnet_stages_arg(p: argparse.ArgumentParser):
    """The hidden ``--resnet-stages`` (e.g. ``1,1,1,1``) with which tests
    shrink ResNet-50's (3, 4, 6, 3)."""
    p.add_argument("--resnet-stages", default=(3, 4, 6, 3),
                   type=lambda v: tuple(int(s) for s in v.split(",")
                                        if s.strip()),
                   help=argparse.SUPPRESS)


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (default: the CUDA device)")


def add_shard_args(p: argparse.ArgumentParser):
    """The trainers' ``--shard-store``, ``--shard-opt-state``,
    ``--model-parallel`` and ``--dist-backend``."""
    p.add_argument("--dist-backend", default="", choices=["", "nccl", "gloo"],
                   help="The process group's backend under a torchrun "
                        "launch (default: NCCL on the cards, gloo with "
                        "--cpu; gloo runs two ranks on one card)")
    p.add_argument("--shard-store", action="store_true",
                   help="Split the image stores over the data-parallel "
                        "ranks (a no-op on one rank)")
    p.add_argument("--shard-opt-state", action="store_true",
                   help="ZeRO-1: each data-parallel rank keeps the Adam "
                        "moments of its slice of every wide parameter "
                        "(a no-op on one rank); the same parameters")
    p.add_argument("--model-parallel", type=int, default=1,
                   help="Tensor parallelism over N ranks (under a "
                        "launch): the wide layers' output channels split "
                        "over each group of N ranks; a value that does not "
                        "divide the ranks trains replicated after a note")


def resolve_device(cpu: bool) -> torch.device:
    """The CPU when asked for, else CUDA; raises when CUDA is missing."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "on the CPU")
    return torch.device("cuda")


def resolve_dtype(name: str, device: torch.device) -> torch.dtype:
    """Map a --compute-dtype value to a torch dtype for ``device``."""
    if name == "auto":
        return torch.float32 if device.type == "cpu" else torch.bfloat16
    return {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
            "f32": torch.float32, "float32": torch.float32}[name]
