"""Step/epoch rate timing (role of xgan/utils/timer.py).

CUDA work is asynchronous, so on a CUDA device the timer synchronises
before it reads the clock: a rate then covers finished device work, not
the enqueue.
"""
from __future__ import annotations

import time

import torch


class StepTimer:
    def __init__(self, device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.reset()

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def tick(self, n: int = 1):
        now = self._now()
        self.total += now - self.t0
        self.count += n
        self.t0 = now

    @property
    def rate(self) -> float:
        return self.count / self.total if self.total > 0 else 0.0

    def reset(self):
        self.t0 = self._now()
        self.count = 0
        self.total = 0.0
