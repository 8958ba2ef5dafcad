"""Image transforms of the data path (role of xgan/data/pipeline.py)."""
from __future__ import annotations

import torch


def tanh_to_u8(x: torch.Tensor) -> torch.Tensor:
    """Generator output in [-1, 1] -> uint8 via ``x*0.5+0.5``, clipped,
    times 255, rounded half to even: the reference's synthetic-image export
    transform, computed on ``x``'s device."""
    y = torch.clamp(x.float() * 0.5 + 0.5, 0.0, 1.0)
    return torch.round(y * 255.0).to(torch.uint8)
