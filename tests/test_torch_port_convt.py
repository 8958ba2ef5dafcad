"""xgan_torch's fused ConvT(k4,s2,p1)+affine+act against the JAX
package's Pallas kernel (interpret mode) and torch's conv_transpose2d.

The plain version is what the CPU path runs; the CUDA kernel is held
against it on the card by chip_smoke.py. Tolerance 2e-4 (rtol and atol)
in f32, as in tests/test_pallas_convt.py: sums of up to 4*512 products
taken in different orders."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xgan.ops.pallas.convt import convt4x4s2_fused as pallas_convt
from xgan_torch import kernels
from xgan_torch.kernels.convt import (convt4x4s2_fused,
                                      convt4x4s2_fused_cuda,
                                      convt4x4s2_fused_ref,
                                      pack_convt_weight)
from xgan_torch.models.convert import convt_hwio_to_torch

torch.set_num_threads(1)

SHAPES = [(4, 7, 512, 8), (2, 8, 16, 8), (3, 5, 6, 4)]


def _act(z, act):
    if act == "relu":
        return np.maximum(z, 0)
    if act == "leaky_relu":
        return np.where(z >= 0, z, 0.2 * z)
    return z


def _inputs(shape, seed):
    b, h, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, h, cin)).astype(np.float32)
    w_hwio = rng.normal(size=(4, 4, cin, cout)).astype(np.float32)
    scale = rng.normal(size=(cout,)).astype(np.float32)
    shift = rng.normal(size=(cout,)).astype(np.float32)
    return x, w_hwio, scale, shift


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_and_conv_transpose(shape, act):
    x, w_hwio, scale, shift = _inputs(shape, seed=sum(shape))
    pallas = np.asarray(pallas_convt(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(scale),
        jnp.asarray(shift), act=act, interpret=True))

    w_torch = torch.from_numpy(convt_hwio_to_torch(w_hwio))
    got = convt4x4s2_fused_ref(
        torch.from_numpy(x), pack_convt_weight(w_torch),
        torch.from_numpy(scale), torch.from_numpy(shift), act).numpy()
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)

    lib = F.conv_transpose2d(torch.from_numpy(x).permute(0, 3, 1, 2),
                             w_torch, stride=2, padding=1)
    lib = _act(lib.permute(0, 2, 3, 1).numpy() * scale + shift, act)
    np.testing.assert_allclose(got, lib, rtol=2e-4, atol=2e-4)


def test_pack_layout():
    """wp[py, px, j0, j1] is W[:, :, 3-py-2*j0, 3-px-2*j1]."""
    w = torch.arange(3 * 2 * 16, dtype=torch.float32).reshape(3, 2, 4, 4)
    wp = pack_convt_weight(w, torch.bfloat16)
    assert wp.shape == (2, 2, 2, 2, 3, 2) and wp.is_contiguous()
    assert wp.dtype == torch.bfloat16
    for py in (0, 1):
        for px in (0, 1):
            for j0 in (0, 1):
                for j1 in (0, 1):
                    torch.testing.assert_close(
                        wp[py, px, j0, j1].float(),
                        w[:, :, 3 - py - 2 * j0, 3 - px - 2 * j1]
                        .to(torch.bfloat16).float(), rtol=0, atol=0)


def test_bf16_plain_keeps_dtype_and_sums_in_f32():
    x, w_hwio, scale, shift = _inputs((2, 4, 8, 5), seed=3)
    wp = pack_convt_weight(torch.from_numpy(convt_hwio_to_torch(w_hwio)),
                           torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = convt4x4s2_fused_ref(xb, wp, torch.from_numpy(scale),
                               torch.from_numpy(shift), "relu")
    assert got.dtype == torch.bfloat16
    # the same bf16 operands summed in f32, rounded once at the end
    want = convt4x4s2_fused_ref(xb.float(), wp.float(),
                                torch.from_numpy(scale),
                                torch.from_numpy(shift), "relu")
    torch.testing.assert_close(got, want.to(torch.bfloat16), rtol=0, atol=0)


def test_cpu_dispatch_runs_plain_version_and_counts_no_launch():
    x, w_hwio, scale, shift = _inputs((2, 3, 4, 3), seed=4)
    args = (torch.from_numpy(x),
            pack_convt_weight(torch.from_numpy(convt_hwio_to_torch(w_hwio))),
            torch.from_numpy(scale), torch.from_numpy(shift))
    kernels.reset_launch_counts()
    torch.testing.assert_close(convt4x4s2_fused(*args, act="relu"),
                               convt4x4s2_fused_ref(*args, act="relu"),
                               rtol=0, atol=0)
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 0


def test_cuda_op_path_rejects_cpu_tensors():
    """The kernel wrapper raises on CPU tensors instead of quietly
    returning the plain version's result."""
    x, w_hwio, scale, shift = _inputs((1, 2, 3, 2), seed=5)
    wp = pack_convt_weight(torch.from_numpy(convt_hwio_to_torch(w_hwio)))
    with pytest.raises(ValueError, match="CUDA"):
        convt4x4s2_fused_cuda(torch.from_numpy(x), wp,
                              torch.from_numpy(scale),
                              torch.from_numpy(shift), "relu")


def test_unknown_act_raises():
    x, w_hwio, scale, shift = _inputs((1, 2, 3, 2), seed=6)
    wp = pack_convt_weight(torch.from_numpy(convt_hwio_to_torch(w_hwio)))
    with pytest.raises(ValueError, match="act"):
        convt4x4s2_fused(torch.from_numpy(x), wp, torch.from_numpy(scale),
                         torch.from_numpy(shift), act="gelu")
