"""What the program modules share: the program as the harness drives it, the
benchmark's weights loaded into the program's nets, and the one-rank
process group of a data-parallel cell."""
from __future__ import annotations

import dataclasses
import socket
from typing import Callable

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Program:
    """The system under test, built once and driven by the harness.

    ``call(rows)``: one call of the timed path on ``(B,)`` indices (one
    step) or ``(K, B)`` (K steps); returns the steps' metrics on the
    device. ``nets`` and ``opts``: ``{"g": ..., "d": ...}``, for the check.
    ``close()``: frees the program's state and leaves its process
    group."""
    call: Callable[[torch.Tensor], torch.Tensor]
    nets: dict
    opts: dict
    close: Callable[[], None]


@torch.no_grad()
def load_weights(net: torch.nn.Module, weights: dict) -> None:
    """Copy the benchmark's initial ``weights`` ({leaf name: tensor}) into
    ``net``'s parameters; the names and shapes must match one to one."""
    params = dict(net.named_parameters())
    if set(params) != set(weights):
        raise ValueError(f"leaves differ: program {sorted(params)}, "
                         f"benchmark {sorted(weights)}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, benchmark "
                             f"{tuple(weights[name].shape)}")
        p.copy_(weights[name])


def join_one_rank(device: torch.device):
    """Join a process group of one rank (NCCL on the card, gloo on the
    CPU) at a free local port; returns the port's ``MeshContext``."""
    from xgan_torch.parallel.mesh import MeshContext
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    return MeshContext(device, 0, 1, True)


def leave_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def assemble(cfg: dict, cell: dict, weights: dict, draw_seed: int,
             g, d, step_fn, mesh) -> Program:
    """The rest of what a loop builds around its nets: the benchmark's
    weights loaded, BN tied to ``mesh`` (a one-rank group, or None), both
    nets' Adam capturable on the card (``train/gan_loop.py``,
    ``train/wgan_loop.py``), one step-draw generator, and the window's call:
    ``step_fn(g, d, opt_g, opt_d, draws, idx)`` itself at K = 1, the
    port's K-step dispatcher (one CUDA graph replay a call) above."""
    from xgan_torch.models.layers import sync_batch_norm
    from xgan_torch.train.common import adam
    from xgan_torch.train.multistep import StepsPerCall

    dev = next(g.parameters()).device
    load_weights(g, weights["g"])
    load_weights(d, weights["d"])
    if mesh is not None:
        sync_batch_norm(g, mesh)
        sync_batch_norm(d, mesh)
    capturable = dev.type == "cuda"
    opt_g, opt_d = (adam(net.parameters(), cfg["lr"], cfg["beta1"],
                         cfg["beta2"], capturable=capturable)
                    for net in (g, d))
    draws = torch.Generator(dev).manual_seed(draw_seed)

    def step(idx):
        return step_fn(g, d, opt_g, opt_d, draws, idx)

    k = cell["steps_per_call"]
    holder = {"call": step if k == 1 else StepsPerCall(step, k, draws)}

    def close():
        holder.clear()
        if mesh is not None:
            leave_group()

    return Program(lambda rows: holder["call"](rows), {"g": g, "d": d},
                   {"g": opt_g, "d": opt_d}, close)
