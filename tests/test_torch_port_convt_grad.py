"""xgan_torch's differentiable ConvT(k4,s2,p1), ``convt4x4s2_train``
(the kernel's forward, cuDNN's backward), against torch's
``F.conv_transpose2d`` under autograd and against ``jax.vjp`` of the JAX
package's flax ``ConvTranspose`` layer, on the spatially flipped HWIO
weight (the layout trap between the two packages).

Shapes are those of tests/test_pallas_convt.py. Tolerance in f32:
1e-4 * (1 + max|ref|), sums of up to 4 * 512 products (dW: B * H * W *
4 of them) taken in different orders. ``gradcheck`` in f64 checks the
backward against finite differences of the forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xgan.models.layers import ConvTranspose
from xgan_torch import kernels
from xgan_torch.kernels.convt import convt4x4s2_fused_ref, convt4x4s2_train
from xgan_torch.models.convert import convt_hwio_to_torch

torch.set_num_threads(1)

SHAPES = [(4, 7, 512, 8), (2, 8, 16, 8), (3, 5, 6, 4)]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-4 * (1 + np.abs(want).max())
    err = np.abs(got - want).max()
    assert err <= tol, f"{what}: max |got - want| {err:.3g} > {tol:.3g}"


def _inputs(shape, seed):
    b, h, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, h, cin)).astype(np.float32)
    w_hwio = (rng.normal(size=(4, 4, cin, cout))
              / np.sqrt(4 * cin)).astype(np.float32)
    g = rng.normal(size=(b, 2 * h, 2 * h, cout)).astype(np.float32)
    return x, w_hwio, g


def _port(x, w_torch, g):
    """(y, dx, dW) of the port, as numpy."""
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w_torch).requires_grad_()
    y = convt4x4s2_train(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    return y.detach().numpy(), dx.numpy(), dw.numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_conv_transpose2d_autograd(shape):
    x, w_hwio, g = _inputs(shape, seed=sum(shape))
    w_torch = convt_hwio_to_torch(w_hwio)
    got = _port(x, w_torch, g)

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w_torch).requires_grad_()
    y = F.conv_transpose2d(xt.permute(0, 3, 1, 2), wt, stride=2,
                           padding=1).permute(0, 2, 3, 1)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(g))
    for what, a, b in zip(("y", "dx", "dW"), got,
                          (y.detach().numpy(), dx.numpy(), dw.numpy())):
        _close(a, b, what)


@pytest.mark.parametrize("shape", SHAPES)
def test_matches_flax_conv_transpose_vjp(shape):
    """The JAX package's own gradients, through the weight flip both
    ways: the flax HWIO kernel goes in as the flipped torch weight, and
    the port's dW comes back flipped into HWIO."""
    x, w_hwio, g = _inputs(shape, seed=sum(shape) + 1)
    layer = ConvTranspose(shape[3], kernel=4, stride=2, padding=1)

    def f(xj, kernel):
        return layer.apply({"params": {"kernel": kernel}}, xj)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w_hwio))
    dx, dw_hwio = vjp(jnp.asarray(g))
    got_y, got_dx, got_dw = _port(x, convt_hwio_to_torch(w_hwio), g)
    _close(got_y, y, "y")
    _close(got_dx, dx, "dx")
    _close(np.transpose(got_dw, (2, 3, 0, 1))[::-1, ::-1], dw_hwio, "dW")


def test_gradcheck_f64():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 2, 4))).requires_grad_()
    w = torch.from_numpy(rng.normal(size=(4, 3, 4, 4))).requires_grad_()
    assert torch.autograd.gradcheck(convt4x4s2_train, (x, w))


def test_bf16_forward_is_one_fused_call_and_grads_keep_dtypes():
    """The forward is the fused function on the weight packed in x's
    dtype; dx comes back in x's dtype and dW in the parameter's (f32),
    and on the CPU no kernel launch is counted."""
    x, w_hwio, g = _inputs((2, 4, 32, 8), seed=9)
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    w = torch.from_numpy(convt_hwio_to_torch(w_hwio)).requires_grad_()
    calls = []

    def spy(*args, **kw):
        calls.append(kw["act"])
        return convt4x4s2_fused_ref(*args, **kw)

    kernels.reset_launch_counts()
    y = convt4x4s2_train(xb, w, spy)
    assert calls == ["none"] and y.dtype == torch.bfloat16
    dx, dw = torch.autograd.grad(y, (xb, w),
                                 torch.from_numpy(g).to(torch.bfloat16))
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.float32
    assert sum(kernels.LAUNCHES.values()) == 0
    want = F.conv_transpose2d(xb.detach().float().permute(0, 3, 1, 2),
                              w.detach().to(torch.bfloat16).float(),
                              stride=2, padding=1).permute(0, 2, 3, 1)
    torch.testing.assert_close(y.float(), want, rtol=2 ** -7, atol=2 ** -7)


def test_weight_only_gradient():
    """With x not requiring a gradient, only dW is computed."""
    x, w_hwio, g = _inputs((1, 3, 4, 2), seed=11)
    w = torch.from_numpy(convt_hwio_to_torch(w_hwio)).requires_grad_()
    y = convt4x4s2_train(torch.from_numpy(x), w)
    (dw,) = torch.autograd.grad(y, (w,), torch.from_numpy(g))
    assert dw.shape == w.shape
