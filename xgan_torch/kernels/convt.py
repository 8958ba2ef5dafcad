"""Fused ConvTranspose2d(k4,s2,p1) + per-channel affine + activation.

Counterpart of the Pallas TPU kernel ``xgan/ops/pallas/convt.py:
convt4x4s2_fused``. ``x (B,H,W,Cin)`` NHWC -> ``(B,2H,2W,Cout)`` in
``x.dtype``; the sum is taken in f32, then ``act(acc * scale + shift)``
with f32 ``(Cout,)`` scale/shift (eval BN folded in, see
``xgan_torch.ops.norm.fold_bn``) and ``act`` in none | relu |
leaky_relu (slope 0.2).

The weight is a torch ConvTranspose2d weight ``(Cin, Cout, 4, 4)``
repacked once by :func:`pack_convt_weight` into phase-major
``(2,2,2,2,Cin,Cout)``: output pixel (2t+py, 2s+px) sums
``x[t-1+py+j0, s-1+px+j1] @ wp[py,px,j0,j1]`` over j0, j1 in {0, 1}
(zero outside the image), with ``wp[py,px,j0,j1] = W[:, :,
3-py-2*j0, 3-px-2*j1]`` -- the mirror of the TPU kernel's ``sel`` on its
spatially flipped HWIO weight.

:func:`convt4x4s2_fused` runs the CUDA kernel (``csrc/convt4x4s2.cu``)
on a CUDA tensor and the plain version :func:`convt4x4s2_fused_ref` on a
CPU tensor. A failed build or launch raises; it never falls back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from xgan_torch import kernels

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}

# ky (or kx) of the torch weight feeding phase p through tap j: 3 - p - 2j
_TAP = torch.tensor([[3, 1], [2, 0]])


def _act_code(act: str) -> int:
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    return ACTS[act]


def pack_convt_weight(w: torch.Tensor,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """torch ConvTranspose2d weight (Cin, Cout, 4, 4) -> contiguous
    phase-major (2, 2, 2, 2, Cin, Cout) ``[py, px, j0, j1]``."""
    if w.dim() != 4 or tuple(w.shape[2:]) != (4, 4):
        raise ValueError(f"expected a (Cin, Cout, 4, 4) weight, got "
                         f"{tuple(w.shape)}")
    tap = _TAP.to(w.device)
    wk = w.permute(2, 3, 0, 1)  # (ky, kx, Cin, Cout)
    wp = wk[tap[:, None, :, None], tap[None, :, None, :]]
    return wp.to(dtype or w.dtype).contiguous()


def convt4x4s2_fused_ref(x, wp, scale, shift, act: str = "none"):
    """Plain torch version: four phase sums as einsums over slices of the
    1-px-padded input, the epilogue in f32, then the interleave."""
    code = _act_code(act)
    b, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    w32 = wp.float()
    rows = []
    for py in (0, 1):
        cols = []
        for px in (0, 1):
            acc = sum(torch.einsum(
                "bhwc,cd->bhwd",
                xp[:, py + j0:py + j0 + h, px + j1:px + j1 + w, :],
                w32[py, px, j0, j1]) for j0 in (0, 1) for j1 in (0, 1))
            acc = acc * scale.float() + shift.float()
            if code == 1:
                acc = torch.relu(acc)
            elif code == 2:
                acc = torch.where(acc >= 0, acc, 0.2 * acc)
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-2))  # (B, H, W, px, C)
    y = torch.stack(rows, dim=2)  # (B, H, py, W, px, C)
    return y.reshape(b, 2 * h, 2 * w, -1).to(x.dtype)


def convt4x4s2_fused_cuda(x, wp, scale, shift, act: str = "none"):
    """Launch the CUDA kernel; raises for tensors that are not on CUDA."""
    if x.device.type != "cuda":
        raise ValueError(f"convt4x4s2_fused_cuda needs CUDA tensors, got "
                         f"x on {x.device}")
    code = _act_code(act)
    from xgan_torch.kernels.build import load_ops
    out = load_ops().convt4x4s2_fused(x, wp, scale, shift, code)
    kernels.LAUNCHES["convt4x4s2_fused"] += 1
    return out


def convt4x4s2_fused(x, wp, scale, shift, act: str = "none"):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return convt4x4s2_fused_ref(x, wp, scale, shift, act)
    return convt4x4s2_fused_cuda(x, wp, scale, shift, act)
