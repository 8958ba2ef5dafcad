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

:func:`convt4x4s2_fused` runs a CUDA kernel on a CUDA tensor and the
plain version :func:`convt4x4s2_fused_ref` on a CPU tensor. The kernel is
chosen by dtype and shape before the launch (:func:`uses_mma`): bf16 with
Cin % 32 == 0 goes to the tensor-core kernel (``csrc/convt4x4s2_mma.cu``,
tiles from :func:`mma_tiles`), everything else to the CUDA-core kernel
(``csrc/convt4x4s2.cu``). A failed build or launch raises; no route falls
back to another. :func:`convt4x4s2_mma_emulate` walks the tensor-core
kernel's grid on the CPU, so its index arithmetic is tested without a
card.

:func:`convt4x4s2_train` is the differentiable form that the train-mode
generator calls: its forward is one :func:`convt4x4s2_fused` call.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from xgan_torch import kernels
from xgan_torch.utils.cache import per_device

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}

# ky (or kx) of the torch weight feeding phase p through tap j: 3 - p - 2j
_TAP = torch.tensor([[3, 1], [2, 0]])


@per_device
def _tap(device: torch.device) -> torch.Tensor:
    """``_TAP`` on ``device``, copied there once."""
    return _TAP.to(device)


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
    tap = _tap(w.device)
    wk = w.permute(2, 3, 0, 1)  # (ky, kx, Cin, Cout)
    wp = wk[tap[:, None, :, None], tap[None, :, None, :]]
    return wp.to(dtype or w.dtype).contiguous()


def convt4x4s2_fused_ref(x, wp, scale, shift, act: str = "none"):
    """Plain torch version: four phase sums as einsums over slices of the
    1-px-padded input, the epilogue in f32 (f64 for f64 inputs, so that
    gradients can be checked numerically), then the interleave."""
    code = _act_code(act)
    b, h, w, _ = x.shape
    acc = torch.promote_types(x.dtype, torch.float32)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1))
    w32 = wp.to(acc)
    rows = []
    for py in (0, 1):
        cols = []
        for px in (0, 1):
            y = sum(torch.einsum(
                "bhwc,cd->bhwd",
                xp[:, py + j0:py + j0 + h, px + j1:px + j1 + w, :],
                w32[py, px, j0, j1]) for j0 in (0, 1) for j1 in (0, 1))
            y = y * scale.to(acc) + shift.to(acc)
            if code == 1:
                y = torch.relu(y)
            elif code == 2:
                y = torch.where(y >= 0, y, 0.2 * y)
            cols.append(y)
        rows.append(torch.stack(cols, dim=-2))  # (B, H, W, px, C)
    y = torch.stack(rows, dim=2)  # (B, H, py, W, px, C)
    return y.reshape(b, 2 * h, 2 * w, -1).to(x.dtype)


class MmaTiles(NamedTuple):
    """Tile configuration of the tensor-core kernel: a block computes a
    ``block_m x block_n`` output tile of one phase, taking K in chunks of
    ``block_k``. block_m and block_k are the kernel's constants BM and BK
    (``csrc/convt4x4s2_mma.cu``); block_n is its template parameter."""
    block_m: int
    block_n: int
    block_k: int


MMA_BLOCK_NS = (8, 32, 64, 128)


def mma_tiles(cin: int, cout: int) -> MmaTiles:
    """The one tile configuration per (Cin, Cout): the smallest block_n
    of :data:`MMA_BLOCK_NS` that covers Cout, 128 above that (Cout then
    takes ceil(Cout / 128) n-tiles)."""
    del cin  # K is walked in chunks of 32 whatever Cin is
    block_n = next((n for n in MMA_BLOCK_NS if n >= cout), MMA_BLOCK_NS[-1])
    return MmaTiles(128, block_n, 32)


def uses_mma(dtype: torch.dtype, cin: int) -> bool:
    """Whether a CUDA input of this dtype and Cin runs on the tensor-core
    kernel (else on the CUDA-core kernel)."""
    return dtype == torch.bfloat16 and cin > 0 and cin % 32 == 0


def convt4x4s2_mma_emulate(x, wp, scale, shift, act: str = "none",
                           tiles: MmaTiles | None = None):
    """CPU emulation of ``csrc/convt4x4s2_mma.cu``: the same grid walked in
    the same order, (m-tile, n-tile, phase) and then the K-chunks (tap,
    Cin-chunk) of each; the same row -> (b, t, s) and (tap, row) -> input
    pixel arithmetic; zero fill for pixels outside the image, rows past M
    and columns past Cout; f32 sums; the epilogue and the one rounding to
    ``x.dtype`` at the store. Raises if an output element is not written
    exactly once."""
    code = _act_code(act)
    b, h, w, cin = x.shape
    cout = wp.shape[-1]
    tiles = tiles or mma_tiles(cin, cout)
    bm, bn, bk = tiles.block_m, tiles.block_n, tiles.block_k
    if cin % bk:
        raise ValueError(f"Cin={cin} is not a multiple of block_k={bk}")
    hw = h * w
    m = b * hw
    chunks_per_tap = cin // bk
    xf = x.reshape(-1, cin)
    wf = wp.reshape(4, 4, cin, cout)  # [phase, tap]
    out = torch.zeros(b * 4 * hw * cout, dtype=x.dtype)
    writes = torch.zeros(b * 4 * hw * cout, dtype=torch.int32)
    for m_tile in range(math.ceil(m / bm)):
        for n_tile in range(math.ceil(cout / bn)):
            for phase in range(4):
                py, px = phase >> 1, phase & 1
                rows = m_tile * bm + torch.arange(bm)
                bi = rows // hw
                r = rows - bi * hw
                t = r // w
                s = r - t * w
                iy0, ix0 = t - 1 + py, s - 1 + px
                pix0 = (bi * h + iy0) * w + ix0
                taps = [(rows < m) & (iy0 + j0 >= 0) & (iy0 + j0 < h)
                        & (ix0 + j1 >= 0) & (ix0 + j1 < w)
                        for j0 in (0, 1) for j1 in (0, 1)]
                cols = n_tile * bn + torch.arange(bn)
                col_ok = cols < cout
                acc = torch.zeros(bm, bn)
                for kt in range(4 * chunks_per_tap):
                    tap, chunk = divmod(kt, chunks_per_tap)
                    ci0 = chunk * bk
                    ok = taps[tap]
                    pix = torch.where(ok, pix0 + (tap >> 1) * w + (tap & 1), 0)
                    a = torch.where(ok[:, None],
                                    xf[pix, ci0:ci0 + bk].float(), 0.0)
                    bmat = torch.zeros(bk, bn)
                    bmat[:, col_ok] = wf[phase, tap, ci0:ci0 + bk,
                                         cols[col_ok]].float()
                    acc += a @ bmat
                # epilogue: rows past M and columns past Cout not stored
                row_ok = rows < m
                n = cols[col_ok]
                y = acc[row_ok][:, col_ok] * scale.float()[n] \
                    + shift.float()[n]
                if code == 1:
                    y = torch.relu(y)
                elif code == 2:
                    y = torch.where(y >= 0, y, 0.2 * y)
                opix = ((bi * 2 * h + 2 * t + py) * 2 * w + 2 * s + px) * cout
                idx = opix[row_ok][:, None] + n[None, :]
                out[idx] = y.to(x.dtype)
                writes[idx] += 1
    if not (writes == 1).all():
        raise RuntimeError("convt4x4s2_mma_emulate: an output element was "
                           "not written exactly once")
    return out.reshape(b, 2 * h, 2 * w, cout)


def convt4x4s2_fused_cuda(x, wp, scale, shift, act: str = "none"):
    """Launch a CUDA kernel, picked by dtype and shape (:func:`uses_mma`);
    raises for tensors that are not on CUDA. Both routes count a
    ``convt4x4s2_fused`` launch; the tensor-core route also counts a
    ``convt4x4s2_mma`` launch."""
    if x.device.type != "cuda":
        raise ValueError(f"convt4x4s2_fused_cuda needs CUDA tensors, got "
                         f"x on {x.device}")
    code = _act_code(act)
    from xgan_torch.kernels.build import load_ops
    ops = load_ops()
    cin = x.shape[-1]
    # while torch.export traces the call it launches nothing: no count
    count = not torch.compiler.is_compiling()
    if uses_mma(x.dtype, cin):
        block_n = mma_tiles(cin, wp.shape[-1]).block_n
        out = ops.convt4x4s2_mma(x, wp, scale, shift, code, block_n)
        kernels.LAUNCHES["convt4x4s2_mma"] += count
    else:
        out = ops.convt4x4s2_fused(x, wp, scale, shift, code)
    kernels.LAUNCHES["convt4x4s2_fused"] += count
    return out


def register_fakes() -> None:
    """Shape functions of the compiled ConvT ops, so that ``torch.export``
    can trace a program that calls them (the ops are declared in C++,
    ``csrc/convt_op.cpp``, without one). Called once, when the library is
    loaded."""
    def out_like(x, wp):
        b, h, w, _ = x.shape
        return x.new_empty((b, 2 * h, 2 * w, wp.shape[-1]))

    torch.library.register_fake("xgan_torch::convt4x4s2_fused")(
        lambda x, wp, scale, shift, act: out_like(x, wp))
    torch.library.register_fake("xgan_torch::convt4x4s2_mma")(
        lambda x, wp, scale, shift, act, block_n: out_like(x, wp))


def convt4x4s2_fused(x, wp, scale, shift, act: str = "none"):
    """The kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return convt4x4s2_fused_ref(x, wp, scale, shift, act)
    return convt4x4s2_fused_cuda(x, wp, scale, shift, act)


class ConvT4x4s2Train(torch.autograd.Function):
    """ConvTranspose2d(k4, s2, p1) of NHWC ``x`` with the torch weight
    ``w (Cin, Cout, 4, 4)``, differentiable in both.

    Forward: ``w`` is packed in ``x.dtype`` and ``convt`` (the fused kernel
    by default) runs with an identity affine and ``act="none"``; train-mode
    BN follows outside. Backward: cuDNN's ``convolution_backward`` on NCHW
    views of the NHWC tensors. The Pallas kernel has no backward either:
    the JAX package takes these gradients from XLA's convolutions
    (``jax.vjp`` of lax ``conv_transpose``), outside any Pallas kernel. The
    weight is cast to ``x.dtype`` for both passes and ``dW`` back to the
    parameter's dtype, as the gradient of flax's cast of its f32 kernel."""

    @staticmethod
    def forward(ctx, x, w, convt):
        cout = w.shape[1]
        ones = torch.ones(cout, device=x.device)
        zeros = torch.zeros(cout, device=x.device)
        x = x.contiguous()  # the kernels take dense NHWC
        y = convt(x, pack_convt_weight(w, x.dtype), ones, zeros, act="none")
        ctx.save_for_backward(x, w)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(x.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2),
            w.to(x.dtype), None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1,
            [need_x, need_w, False])
        return (dx.permute(0, 2, 3, 1) if need_x else None,
                dw.to(w.dtype) if need_w else None, None)


def convt4x4s2_train(x, w, convt=convt4x4s2_fused):
    """Differentiable ConvT(k4, s2, p1): NHWC ``x``, torch weight ``w``
    ``(Cin, Cout, 4, 4)`` (the f32 parameter) -> ``(B, 2H, 2W, Cout)`` in
    ``x.dtype``. ``convt`` is the forward; a check of the kernel passes
    :func:`convt4x4s2_fused_ref` to run the plain version on the card."""
    return ConvT4x4s2Train.apply(x, w, convt)
