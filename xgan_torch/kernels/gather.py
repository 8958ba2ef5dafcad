"""Mixed-source batch gather.

Counterpart of the Pallas TPU kernel ``xgan/ops/pallas/gather.py:
mixed_gather``: ``out[i] = synth[synth_idx[i]] if use_synth[i] else
real[real_idx[i]]`` over uint8 stores ``real (Nr,S,S,3)`` and ``synth
(Ns,S,S,3)``, with ``(B,)`` int64 indices and a ``(B,)`` bool mask. The
curriculum mixer (``xgan_torch.data.mixer.mix_batch``) and the concat
batch source (``xgan_torch.train.classifier.gather_concat``) build their
images with it.

Fold-batched form (``--parallel-folds``): ``(k, B)`` indices and mask over
the shared stores give ``(k, B, S, S, 3)``, the counterpart of the Pallas
call under xgan's fold ``vmap``. It is one launch over the ``k * B`` rows
(one count in ``LAUNCHES``), and its plain version is the plain version
over the flattened rows.

:func:`mixed_gather` runs the CUDA kernel (``csrc/mixed_gather.cu``) on
CUDA tensors and the plain version :func:`mixed_gather_ref` on CPU
tensors. Both reject an index out of range (negative ones included) with
``IndexError``. The plain version raises at once; the kernel skips the
copy and sets a device flag, read by :func:`raise_if_flagged`, so that a
train step need not wait for the device. A caller that passes no flag
gets a fresh one, checked before the call returns.

Across data-parallel ranks (:func:`mixed_gather_ranks`, the counterpart of
``mixed_gather_spmd``) the stores are replicated on every rank and each
rank launches the kernel on its own rows of the global index vectors.
"""
from __future__ import annotations

import torch

from xgan_torch import kernels


def _check_index(idx: torch.Tensor, n: int, what: str) -> None:
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(f"mixed_gather: {what} index out of range for a "
                         f"store of {n} rows")


def mixed_gather_ref(real, synth, real_idx, synth_idx, use_synth):
    """Plain torch version: both gathers, then a select, over the
    flattened rows of (B,) or (k, B) indices."""
    if not real_idx.shape == synth_idx.shape == use_synth.shape:
        raise ValueError(f"mixed_gather: index and mask shapes differ: "
                         f"{tuple(real_idx.shape)}, "
                         f"{tuple(synth_idx.shape)}, "
                         f"{tuple(use_synth.shape)}")
    _check_index(real_idx, real.shape[0], "real")
    _check_index(synth_idx, synth.shape[0], "synthetic")
    shape = real_idx.shape
    real_idx, synth_idx = real_idx.reshape(-1), synth_idx.reshape(-1)
    out = torch.where(use_synth.reshape(-1, 1, 1, 1), synth[synth_idx],
                      real[real_idx])
    return out.reshape(*shape, *real.shape[1:])


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


def mixed_gather_ranks(real, synth, real_idx, synth_idx, use_synth,
                       rows, err: torch.Tensor | None = None, *,
                       gather=mixed_gather):
    """``mixed_gather`` of this rank's ``rows`` of the global (B,) index
    vectors and mask, against stores replicated on every rank: the
    counterpart of ``mixed_gather_spmd`` (the kernel on CUDA tensors, one
    launch a rank; the plain version on CPU tensors). ``rows``: a slice
    (a slice of a 1-D contiguous tensor is contiguous, as the op
    requires: it reads the slice in place) or an int64 index (a rank's
    share of every microbatch, ``MeshContext.local_rows(b, accum)``: the
    selected rows come out copied, contiguous). ``gather``: the single-rank call, which a check may
    replace with its plain version."""
    return gather(real, synth, real_idx[rows], synth_idx[rows],
                  use_synth[rows], err)
