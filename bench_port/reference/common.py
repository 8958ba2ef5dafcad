"""Plain PyTorch pieces shared by the GAN references.

Everything runs in float32 on NCHW tensors with plain operators
(``F.conv2d``, ``F.conv_transpose2d``, ``F.batch_norm`` in train mode); no
kernel, no packed weight and nothing of the program under test. The
caller turns TF32 off (:func:`plain_float32`).

``Numerics`` is the precision of the activations and of the operands of
every product: ``f32`` (the reference) or ``fp8`` (the control: float8
e4m3, one scale per tensor, wherever the program holds bfloat16: each
convolution's inputs and weights, the output of each convolution, BN and
activation, and in the backward the gradient at each of those points;
statistics, accumulation, losses and Adam in float32, as the program
keeps them).

``fault`` plants one of the faults that the check must catch into the
reference put in the program's place: ``half_batch`` (half of the batch
left out, the means taken over the rest).
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FP8_MAX = 448.0  # the largest float8 e4m3 value
FAULTS = ("half_batch",)


@contextlib.contextmanager
def plain_float32():
    """TF32 off for matrix products and cuDNN while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@dataclasses.dataclass(frozen=True)
class Numerics:
    precision: str = "f32"

    def __post_init__(self):
        if self.precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {self.precision!r}")

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as an operand of a product in this precision."""
        return t if self.precision == "f32" else _round_fp8(t)

    def act(self, y: torch.Tensor) -> torch.Tensor:
        """An activation held in this precision: rounded, and its gradient
        rounded in the backward."""
        if self.precision == "f32":
            return y
        return _RoundGrad.apply(_round_fp8(y))

    def conv(self, x, w, stride=1, padding=0):
        return self.act(F.conv2d(self.q(x), self.q(w), None, stride,
                                 padding))

    def convt(self, x, w, stride=1, padding=0):
        return self.act(F.conv_transpose2d(self.q(x), self.q(w), None,
                                           stride, padding))


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale (its largest magnitude
    at the format's largest value), the rounding passed through unchanged
    by the backward."""
    d = t.detach()
    scale = FP8_MAX / d.abs().amax().clamp(min=1e-30)
    rounded = (d * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (rounded - d)


class _RoundGrad(torch.autograd.Function):
    """Identity forward; the backward rounds the incoming gradient to
    float8 (differentiably, for a double backward)."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g)


def bn_train(x: torch.Tensor, weight, bias, eps: float = 1e-5):
    """Train-mode BN over the batch and spatial axes of NCHW ``x``."""
    return F.batch_norm(x, None, None, weight, bias, training=True,
                        eps=eps)


def real_batch(store_u8: torch.Tensor, idx: torch.Tensor,
               flip: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` of the uint8 NHWC store, each flipped left-right where
    ``flip``, scaled to [0, 1] and normalized by the ImageNet statistics:
    NCHW float32."""
    x = store_u8[idx].float() / 255.0
    x = torch.where(flip[:, None, None, None], x.flip(2), x)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def bce_logits_mean(logits: torch.Tensor, label: float) -> torch.Tensor:
    """Mean binary cross-entropy of ``logits`` against one label."""
    return F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, label))


class Adam:
    """Adam as in Kingma and Ba (bias-corrected moments, eps outside the
    root) over a dict of float32 leaves, updated in place."""

    def __init__(self, params: dict, lr: float, beta1: float, beta2: float,
                 eps: float = 1e-8):
        self.params = params
        self.lr, self.beta1, self.beta2, self.eps = lr, beta1, beta2, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        c1 = 1.0 - self.beta1 ** self.t
        c2 = 1.0 - self.beta2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.beta1).add_(g, alpha=1.0 - self.beta1)
            self.v[k].mul_(self.beta2).addcmul_(g, g, value=1.0 - self.beta2)
            denom = (self.v[k] / c2).sqrt().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def leaf_params(weights: dict) -> dict:
    """Fresh float32 leaves that require gradients, from ``weights``."""
    return {k: t.detach().clone().float().requires_grad_()
            for k, t in weights.items()}


def grads_of(loss: torch.Tensor, params: dict, **kw) -> dict:
    names = list(params)
    gs = torch.autograd.grad(loss, [params[k] for k in names], **kw)
    return dict(zip(names, gs))


def on_host(tensors: dict) -> dict:
    """Float32 copies on the host."""
    return {k: t.detach().float().cpu() for k, t in tensors.items()}


def changes(params: dict, initial: dict) -> dict:
    """Each leaf's 2-norm of its change from ``initial``."""
    return {k: float((p.detach().double() - initial[k].double()).norm())
            for k, p in params.items()}


@dataclasses.dataclass
class Outputs:
    """What the check compares, from the program or from a reference:
    ``metrics[t]`` the values step t returned, ``first_grads[net][leaf]``
    each leaf's gradient at the net's first update (float32, on the host),
    ``change[net][leaf]`` the norm of each leaf's change after the
    compared steps."""
    metrics: list
    first_grads: dict
    change: dict


def batch_rows(b: int, fault: str | None) -> slice:
    """The rows of a batch of ``b`` that a step uses: all, or the first
    half under the ``half_batch`` fault."""
    if fault is None:
        return slice(None)
    if fault == "half_batch":
        return slice(0, b // 2)
    raise ValueError(f"unknown fault {fault!r}; known: {FAULTS}")
