"""Epoch-loop helpers (role of xgan/train/loop_common.py)."""
from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from xgan_torch.data.pipeline import epoch_batches


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


def epoch_plan(n_valid: int, batch_size: int, data_rng,
               limit_batches: int, device: torch.device):
    """One epoch's batches on ``device``: the ``(num_batches, B)`` int64
    row indices in the JAX package's order (``epoch_batches``, cut to
    ``limit_batches`` when set) and the final batch's validity mask
    (:func:`batch_tail_mask`), or None when that batch is full."""
    batches = epoch_batches(n_valid, batch_size, data_rng)
    if limit_batches:
        batches = batches[:limit_batches]
    t_mask = batch_tail_mask(n_valid, batches.shape[0], batch_size)
    if t_mask is not None:
        t_mask = torch.from_numpy(t_mask).to(device)
    return torch.from_numpy(batches.astype(np.int64)).to(device), t_mask


def save_gan_checkpoints(model_dir: str, tag: str, g, d) -> None:
    """``generator_{tag}.pth`` and ``discriminator_{tag}.pth``: host copies
    of the reference-layout state dicts."""
    torch.save(host_state(g), os.path.join(model_dir,
                                            f"generator_{tag}.pth"))
    torch.save(host_state(d), os.path.join(model_dir,
                                            f"discriminator_{tag}.pth"))


def host_state(model) -> dict:
    """A copy of ``model``'s state dict on the host (a checkpoint that
    later steps do not change)."""
    return {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}


def grid_iters(iters: int, save_interval: int, last_epoch: bool, i: int,
               num_batches: int) -> list[int]:
    """The iterations whose sample sheet is due after iteration ``iters``
    (the ``i``-th batch of its epoch): ``[iters]`` every
    ``save_interval`` iterations, as the reference (train_gan.py:166-169),
    and after the final iteration of the final epoch; else ``[]``."""
    due = iters % save_interval == 0 or (last_epoch and i == num_batches - 1)
    return [iters] if due else []


def checkpoint_boundary(epoch: int, epochs: int, interval: int) -> bool:
    """Whether checkpoints are due after ``epoch`` (0-based): every
    ``interval`` epochs and after the final one."""
    return (epoch + 1) % interval == 0 or epoch + 1 == epochs


def gan_live_postfix(m) -> str:
    """DCGAN step metrics [G, D, D_x, D_G_z1, D_G_z2] for the progress
    line."""
    return f"Loss_D: {m[1]:.4f}, Loss_G: {m[0]:.4f}, D(x): {m[2]:.4f}"


def wgan_live_postfix(m) -> str:
    """WGAN-GP step losses [d_1, ..., d_n, g] for the progress line: the
    last critic loss, as the JAX package shows it."""
    return f"Loss_D: {m[-2]:.4f}"


class EpochProgress:
    """In-epoch progress line that never waits for the device: it counts
    batches dispatched and their rate. Writes only to a terminal and
    redraws at most ~10 times a second.

    With ``postfix_fn``, the line also shows a recent step's metrics: at
    a redraw the step's metrics are copied to the host without blocking,
    and shown at a later redraw once that copy has landed."""

    def __init__(self, label: str, num_batches: int, postfix_fn=None):
        self.enabled = sys.stdout.isatty()
        self.label = label
        self.total = num_batches
        self.t0 = time.time()
        self._last = 0.0
        self.postfix_fn = postfix_fn
        self.postfix = ""
        self._pending = None  # (host copy, CUDA event or None)

    def update(self, i: int, metrics: torch.Tensor | None = None) -> None:
        if not self.enabled:
            return
        now = time.time()
        if now - self._last < 0.1 and i < self.total:
            return
        if self.postfix_fn is not None and metrics is not None:
            self._poll(metrics)
        rate = i / max(now - self.t0, 1e-9)
        sys.stdout.write(f"\r{self.label}: {i}/{self.total} batches "
                         f"dispatched ({rate:.1f}/s){self.postfix}")
        sys.stdout.flush()
        self._last = now

    def _poll(self, metrics: torch.Tensor) -> None:
        if self._pending is not None:
            host, done = self._pending
            if done is None or done.query():
                self.postfix = ", " + self.postfix_fn(host.numpy())
                self._pending = None
        if self._pending is None:
            on_cuda = metrics.is_cuda
            host = torch.empty(metrics.shape, dtype=metrics.dtype,
                               pin_memory=on_cuda)
            host.copy_(metrics, non_blocking=on_cuda)
            done = None
            if on_cuda:
                done = torch.cuda.Event()
                done.record()
            self._pending = (host, done)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.enabled:  # clear the line, also when a step raised
            sys.stdout.write("\r\x1b[2K")
            sys.stdout.flush()
        return False
