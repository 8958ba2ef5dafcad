"""The tensor-core ConvT kernel's tile walk, emulated on the CPU
(``convt4x4s2_mma_emulate``), against the plain version and the JAX
package's Pallas kernel (interpret mode), and the route that sends a CUDA
input to that kernel or to the CUDA-core one.

The emulation walks the CUDA kernel's grid with its index arithmetic and
zero fills; the kernel itself is held against the plain version on the
card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``). Tolerances:
rtol = atol = 2e-4 in f32, as in ``tests/test_torch_port_convt.py`` (sums
in another order); in bf16 2**-7 * (1 + max|ref|), as ``chip_smoke.py``
holds the kernel (the two may round one f32 sum to neighbouring bf16
values)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgan.ops.pallas.convt import convt4x4s2_fused as pallas_convt
from xgan_torch.kernels.convt import (MmaTiles, convt4x4s2_fused_ref,
                                      convt4x4s2_mma_emulate, mma_tiles,
                                      pack_convt_weight, uses_mma)
from xgan_torch.models.convert import convt_hwio_to_torch

torch.set_num_threads(1)

# (H, Cin, Cout) of the five k4s2 layers of the G-224 ladder (fg 64)
G224 = [(7, 512, 256), (14, 256, 128), (28, 128, 64), (56, 64, 32),
        (112, 32, 3)]
# the same for the WGAN-GP generator, the DCGAN ladder one width up
WGAN224 = [(7, 1024, 512), (14, 512, 256), (28, 256, 128), (56, 128, 64),
           (112, 64, 3)]

# (B, H, W, Cin, Cout): every block_n (8: Cout 3 and 8; 32; 64: Cout 40 and
# 64; 128: Cout 128 and 256 in two n-tiles), a ragged M inside one m-tile
# (75 rows) and across two (189), H != W, and two chunks per tap (Cin 64)
SHAPES = [(1, 2, 2, 32, 8), (3, 7, 9, 32, 3), (3, 5, 5, 32, 32),
          (2, 4, 6, 32, 40), (2, 3, 5, 64, 64), (1, 4, 4, 32, 128),
          (2, 3, 3, 64, 256)]


def _inputs(shape, seed):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    w_hwio = (rng.normal(size=(4, 4, cin, cout))
              / np.sqrt(4 * cin)).astype(np.float32)
    scale = rng.normal(size=(cout,)).astype(np.float32)
    shift = rng.normal(size=(cout,)).astype(np.float32)
    return x, w_hwio, scale, shift


def _torch_args(x, w_hwio, scale, shift, dtype=torch.float32):
    wp = pack_convt_weight(torch.from_numpy(convt_hwio_to_torch(w_hwio)),
                           dtype)
    return (torch.from_numpy(x).to(dtype), wp, torch.from_numpy(scale),
            torch.from_numpy(shift))


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_emulation_matches_plain_and_pallas(shape, act):
    x, w_hwio, scale, shift = _inputs(shape, seed=sum(shape))
    args = _torch_args(x, w_hwio, scale, shift)
    got = convt4x4s2_mma_emulate(*args, act=act).numpy()
    assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
    np.testing.assert_allclose(got, convt4x4s2_fused_ref(*args, act).numpy(),
                               rtol=2e-4, atol=2e-4)
    pallas = np.asarray(pallas_convt(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(scale),
        jnp.asarray(shift), act=act, interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", [(3, 7, 9, 32, 3), (2, 4, 6, 32, 40),
                                   (2, 3, 3, 64, 256)])
def test_emulation_bf16_matches_plain(shape, act):
    """bf16 operands, f32 sums, one rounding to bf16 after the epilogue."""
    args = _torch_args(*_inputs(shape, seed=7), dtype=torch.bfloat16)
    got = convt4x4s2_mma_emulate(*args, act=act)
    want = convt4x4s2_fused_ref(*args, act)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    tol = 2 ** -7 * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("layer", [WGAN224[0], WGAN224[-1]],
                         ids=["1024to512at7", "64to3at112"])
def test_emulation_at_the_wgan_end_layers(layer, act):
    """The WGAN-GP ladder's first k4s2 layer (Cin = 1024: 128 K-chunks a
    tile, four n-tiles of 128) and its last (64 -> 3 at 112 x 112:
    block_n 8, Cout padded from 3, 98 m-tiles), at batch 1, bf16 with the
    sampler's BN+ReLU epilogue and the train forward's act none, against
    the plain version."""
    h, cin, cout = layer
    args = _torch_args(*_inputs((1, h, h, cin, cout), seed=h + cin),
                       dtype=torch.bfloat16)
    got = convt4x4s2_mma_emulate(*args, act=act)
    want = convt4x4s2_fused_ref(*args, act)
    assert got.shape == (1, 2 * h, 2 * h, cout)
    tol = 2 ** -7 * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("tiles", [MmaTiles(16, 8, 32), MmaTiles(32, 16, 32),
                                   MmaTiles(8, 64, 64)])
def test_emulation_with_small_tiles(tiles):
    """Many ragged m- and n-tiles: every output written once, same sums."""
    args = _torch_args(*_inputs((2, 5, 3, 64, 40), seed=11))
    np.testing.assert_allclose(
        convt4x4s2_mma_emulate(*args, act="leaky_relu", tiles=tiles).numpy(),
        convt4x4s2_fused_ref(*args, "leaky_relu").numpy(),
        rtol=2e-4, atol=2e-4)


def test_emulation_rejects_cin_not_multiple_of_block_k():
    args = _torch_args(*_inputs((1, 2, 2, 48, 8), seed=12))
    with pytest.raises(ValueError, match="block_k"):
        convt4x4s2_mma_emulate(*args)


def test_tile_table():
    """One configuration per block_n; Cout above 128 takes n-tiles of 128."""
    tiles = [mma_tiles(cin, cout) for _, cin, cout in G224]
    assert [(t.block_n, math.ceil(cout / t.block_n))
            for t, (_, _, cout) in zip(tiles, G224)] \
        == [(128, 2), (128, 1), (64, 1), (32, 1), (8, 1)]
    assert mma_tiles(64, 40) == MmaTiles(128, 64, 32)
    assert [mma_tiles(32, c).block_n for c in (1, 8, 9, 33, 65, 129, 300)] \
        == [8, 8, 32, 64, 128, 128, 128]
    # the WGAN-GP ladder: the same block_n set (8, 64, 128), so the same
    # kernel instantiations
    wgan = [mma_tiles(cin, cout) for _, cin, cout in WGAN224]
    assert [(t.block_n, math.ceil(cout / t.block_n))
            for t, (_, _, cout) in zip(wgan, WGAN224)] \
        == [(128, 4), (128, 2), (128, 1), (64, 1), (8, 1)]


def test_route():
    """The five bf16 layers of both G-224 ladders go to the tensor-core
    kernel; f32 and a Cin that is not a multiple of 32 go to the CUDA-core
    kernel."""
    assert all(uses_mma(torch.bfloat16, cin) for _, cin, _ in G224 + WGAN224)
    assert not any(uses_mma(torch.float32, cin) for _, cin, _ in G224)
    assert not uses_mma(torch.bfloat16, 100)
    assert not uses_mma(torch.bfloat16, 1)
    assert not uses_mma(torch.bfloat16, 48)
    assert not uses_mma(torch.float16, 64)
