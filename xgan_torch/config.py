"""Shared CLI flags and device/dtype resolution (role of xgan/config.py).

``--compute-dtype auto`` is bf16 on CUDA and f32 on the CPU. The device is
CUDA unless ``--cpu`` is given; without a CUDA device and without
``--cpu`` the entry points stop with a structured error instead of
continuing on the CPU.
"""
from __future__ import annotations

import argparse

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


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--cpu", action="store_true",
                   help="Run on the CPU (default: the CUDA device)")


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
