"""A per-device constant cache that ``torch.export`` cannot poison."""
from __future__ import annotations

import functools

import torch


def per_device(fn):
    """``fn(device)`` computed once per device and kept: a host-to-device
    copy inside a step could not be captured into a CUDA graph. While
    ``torch.export`` traces, ``fn`` runs afresh, so that no traced tensor
    lands in the cache."""
    cached = functools.lru_cache(maxsize=None)(fn)

    @functools.wraps(fn)
    def get(device: torch.device):
        return fn(device) if torch.compiler.is_compiling() else cached(device)
    return get
