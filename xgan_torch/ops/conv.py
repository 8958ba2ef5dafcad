"""Convolutions whose input gradient is differentiated again (the WGAN-GP
penalty's critic on x̂).

Autograd differentiates ``F.conv2d``'s input gradient through
``ConvolutionBackward0``'s own backward, ``aten::_convolution_double_
backward``, which computes the weight term as a *forward* convolution of
the input gradient with the output gradient as its filter, dilated by the
stride: for the WGAN-GP critic at 224 px a 112x112 (conv 1) ... 14x14
(conv 4) filter with a 4x4 output, which cuDNN runs on the CUDA cores
(``implicit_convolve_sgemm``).

:func:`conv2d_double_backward` is the same convolution, an autograd
Function whose backward writes the input gradient out as the transposed
convolution ``F.conv_transpose2d(gy, w, stride, padding,
output_padding)``, an op of its own on the graph: differentiating it
again is that op's first backward, a cuDNN weight gradient (in ``w``)
and a forward convolution (in ``gy``), on the tensor cores. The weight
gradient is ``aten.convolution_backward``'s, weight only. A Function's
``needs_input_grad`` is fixed at its forward, so a backward that takes
the input gradient alone (the penalty's ``inputs=x̂``) computes the
weight gradient too, and drops it: one weight gradient a conv a critic
update, unreachable from the loss, so never differentiated.

``CALLS["conv2d_input_grad"]`` counts the input gradients built to be
differentiated again, one a conv in a ``create_graph=True`` backward: 5
per critic update of the WGAN-GP step, 0 in a DCGAN step (the loss's
first-order backward through the same convs is not counted). Reset it,
drive the path, read it.
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

CALLS: Counter = Counter()


def reset_call_counts() -> None:
    CALLS.clear()


class Conv2dDoubleBackward(torch.autograd.Function):
    """``F.conv2d(x, w, None, stride, padding)``, its input gradient a
    transposed convolution and its weight gradient cuDNN's, both
    differentiable (see the module docstring)."""

    @staticmethod
    def forward(ctx, x, w, stride: int, padding: int):
        ctx.save_for_backward(x, w)
        ctx.geometry = stride, padding
        return F.conv2d(x, w, None, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geometry
        need_x, need_w = ctx.needs_input_grad[:2]
        dx = dw = None
        if need_x:
            kh, kw = w.shape[2:]
            out_pad = [n - ((m - 1) * stride - 2 * padding + k)
                       for n, m, k in zip(x.shape[2:], gy.shape[2:],
                                          (kh, kw))]
            # in x's memory format, as the plain conv's input gradient: the
            # transposed conv's output takes its input's, and the head's
            # one-channel gy reads as NCHW
            fmt = (torch.channels_last
                   if x.is_contiguous(memory_format=torch.channels_last)
                   else torch.contiguous_format)
            dx = F.conv_transpose2d(gy.contiguous(memory_format=fmt), w,
                                    None, stride, padding, out_pad)
            if torch.is_grad_enabled():
                CALLS["conv2d_input_grad"] += 1
        if need_w:
            dw = torch.ops.aten.convolution_backward(
                gy, x, w, None, [stride] * 2, [padding] * 2, [1, 1], False,
                [0, 0], 1, [False, True, False])[1]
        return dx, dw, None, None


def conv2d_double_backward(x: torch.Tensor, w: torch.Tensor,
                           stride: int = 1, padding: int = 0
                           ) -> torch.Tensor:
    """``F.conv2d(x, w, None, stride, padding)`` (no bias, dilation 1, one
    group; ``w`` in ``x``'s dtype, its gradient in that dtype too) whose
    input gradient is a transposed convolution on the graph."""
    return Conv2dDoubleBackward.apply(x, w, stride, padding)
