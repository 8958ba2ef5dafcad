"""Exponential moving average of the generator's weights
(``--ema-decay``; role of xgan/train/ema.py).

``ema <- ema * d + (1 - d) * param`` after every G Adam step, over G's
parameters (not its BN buffers: those are already a running average, and
the EMA checkpoint pairs the EMA parameters with the raw generator's
buffers, :func:`xgan_torch.train.loop_common.ema_state`). The EMA is
write-only: nothing in the step reads it, so training with it on is
bitwise the same as with it off. Under tensor parallelism it holds
this rank's slices of G's parameters (made after the placement), and the
checkpoints and snapshots assemble it whole.
"""
from __future__ import annotations

import numpy as np
import torch


def init_ema(g: torch.nn.Module) -> dict[str, torch.Tensor]:
    """{name: f32 copy} of ``g``'s parameters."""
    return {name: p.detach().float().clone()
            for name, p in g.named_parameters()}


@torch.no_grad()
def ema_update(ema: dict[str, torch.Tensor], g: torch.nn.Module,
               decay: float) -> None:
    """One EMA step in place, as the JAX package rounds it: ``ema * d``
    and ``(1 - d) * param`` each rounded to f32, then their sum, with
    ``d`` and ``1 - d`` f32 numbers. One pass of ``torch._foreach_*``
    over the parameter list; it adds no host sync, so it runs inside a
    captured CUDA graph."""
    d = np.float32(decay)
    one_minus_d = float(np.float32(1.0) - d)
    params = dict(g.named_parameters())
    e = list(ema.values())
    p = [params[k].detach().float() for k in ema]
    torch._foreach_mul_(e, float(d))
    torch._foreach_add_(e, torch._foreach_mul(p, one_minus_d))
