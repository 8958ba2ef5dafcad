"""Epoch-loop helpers (role of xgan/train/loop_common.py)."""
from __future__ import annotations

import sys
import time

import numpy as np


def batch_tail_mask(n_valid: int, num_batches: int, batch_size: int):
    """0/1 float32 validity mask of an epoch's final batch, or None when
    that batch is full. ``epoch_batches`` wrap-pads the last batch, so its
    padded rows are its tail; the mask gives the step the reference
    DataLoader's smaller final batch for the loss, the gradient and the BN
    statistics. With --limit-batches the kept batches are all full."""
    pad = num_batches * batch_size - n_valid
    if pad <= 0:
        return None
    return np.concatenate([np.ones(batch_size - pad, np.float32),
                           np.zeros(pad, np.float32)])


class EpochProgress:
    """In-epoch progress line that never waits for the device: it counts
    batches dispatched and their rate. Writes only to a terminal and
    redraws at most ~10 times a second."""

    def __init__(self, label: str, num_batches: int):
        self.enabled = sys.stdout.isatty()
        self.label = label
        self.total = num_batches
        self.t0 = time.time()
        self._last = 0.0

    def update(self, i: int) -> None:
        if not self.enabled:
            return
        now = time.time()
        if now - self._last < 0.1 and i < self.total:
            return
        rate = i / max(now - self.t0, 1e-9)
        sys.stdout.write(f"\r{self.label}: {i}/{self.total} batches "
                         f"dispatched ({rate:.1f}/s)")
        sys.stdout.flush()
        self._last = now

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.enabled:  # clear the line, also when a step raised
            sys.stdout.write("\r\x1b[2K")
            sys.stdout.flush()
        return False
