"""Step/epoch rate timing and the optional profiler window
(role of xgan/utils/timer.py).

CUDA work is asynchronous, so on a CUDA device the timer synchronises
before it reads the clock: a rate then covers finished device work, not
the enqueue.
"""
from __future__ import annotations

import contextlib
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


# tiny kernels that open a trace window on a CUDA device, and the idle
# host seconds after them and before the window closes; see maybe_trace
_TRACE_LEAD_KERNELS = 64
_TRACE_PAD_S = 0.5


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None):
    """A ``torch.profiler`` window (host activity, and the CUDA device's
    when there is one) that writes one Chrome/TensorBoard trace,
    ``<worker>.<time>.pt.trace.json``, into ``trace_dir`` when the window
    closes, also when it closes on an exception; a no-op when
    ``trace_dir`` is empty.

    On a CUDA device the window opens with ``_TRACE_LEAD_KERNELS`` tiny
    kernels under a ``trace_lead`` annotation, synchronised and followed
    by ``_TRACE_PAD_S`` of idle host time before the traced work, and
    closes ``_TRACE_PAD_S`` after the work has finished. The profiler
    keeps a kernel only if its time, mapped from the device's clock onto
    the host's, lies inside the window, and that mapping can be off by
    milliseconds: without the margins it dropped the head of the traced
    epoch (its first gather among them)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                tensorboard_trace_handler)
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()  # the window holds this epoch's work only
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(trace_dir)):
        if cuda:
            with record_function("trace_lead"):
                lead = torch.zeros(1, device="cuda")
                for _ in range(_TRACE_LEAD_KERNELS):
                    lead.add_(1)
                torch.cuda.synchronize()
                time.sleep(_TRACE_PAD_S)
        yield
        if cuda:
            torch.cuda.synchronize()
            time.sleep(_TRACE_PAD_S)
