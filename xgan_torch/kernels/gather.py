"""Mixed-source batch gather.

Counterpart of the Pallas TPU kernel ``xgan/ops/pallas/gather.py:
mixed_gather``: ``out[i] = synth[synth_idx[i]] if use_synth[i] else
real[real_idx[i]]`` over uint8 stores ``real (Nr,S,S,3)`` and ``synth
(Ns,S,S,3)``, with ``(B,)`` int64 indices and a ``(B,)`` bool mask. The
curriculum mixer (``xgan_torch.data.mixer.mix_batch``) and the concat
batch source (``xgan_torch.train.classifier.gather_concat``) build their
images with it.

:func:`mixed_gather` runs the CUDA kernel (``csrc/mixed_gather.cu``) on
CUDA tensors and the plain version :func:`mixed_gather_ref` on CPU
tensors. Both reject an index out of range (negative ones included) with
``IndexError``. The plain version raises at once; the kernel skips the
copy and sets a device flag, read by :func:`raise_if_flagged`, so that a
train step need not wait for the device. A caller that passes no flag
gets a fresh one, checked before the call returns.
"""
from __future__ import annotations

import torch

from xgan_torch import kernels


def _check_index(idx: torch.Tensor, n: int, what: str) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"mixed_gather: {what} index out of range for a "
                         f"store of {n} rows")


def mixed_gather_ref(real, synth, real_idx, synth_idx, use_synth):
    """Plain torch version: both gathers, then a select."""
    _check_index(real_idx, real.shape[0], "real")
    _check_index(synth_idx, synth.shape[0], "synthetic")
    return torch.where(use_synth[:, None, None, None], synth[synth_idx],
                       real[real_idx])


def new_error_flag(device) -> torch.Tensor:
    """A cleared one-element flag for :func:`mixed_gather_cuda`."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def raise_if_flagged(err: torch.Tensor) -> None:
    """Raise ``IndexError`` if a launch that shared ``err`` met an index
    out of range. Reading the flag waits for those launches."""
    if int(err.item()):
        raise IndexError("mixed_gather: an index was out of range for its "
                         "store; the rows it selected were not copied")


def mixed_gather_cuda(real, synth, real_idx, synth_idx, use_synth,
                      err: torch.Tensor | None = None):
    """Launch the CUDA kernel; raises for tensors that are not on CUDA.

    ``err``: the device flag the kernel sets on a bad index; the caller
    reads it later with :func:`raise_if_flagged`. Without one, the call
    makes its own and checks it (which waits for the device)."""
    if real.device.type != "cuda":
        raise ValueError(f"mixed_gather_cuda needs CUDA tensors, got the "
                         f"real store on {real.device}")
    own = err is None
    if own:
        err = new_error_flag(real.device)
    from xgan_torch.kernels.build import load_ops
    out = load_ops().mixed_gather(real, synth, real_idx, synth_idx,
                                  use_synth, err)
    if out.numel():  # the op launches nothing for an empty batch
        kernels.LAUNCHES["mixed_gather"] += 1
    if own:
        raise_if_flagged(err)
    return out


def mixed_gather(real, synth, real_idx, synth_idx, use_synth,
                 err: torch.Tensor | None = None):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if real.device.type == "cpu":
        return mixed_gather_ref(real, synth, real_idx, synth_idx, use_synth)
    return mixed_gather_cuda(real, synth, real_idx, synth_idx, use_synth,
                             err)
