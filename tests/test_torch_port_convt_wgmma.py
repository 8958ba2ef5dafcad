"""The warpgroup (wgmma) ConvT kernels' tile walks, emulated on the CPU
(``convt4x4s2_wgmma_emulate`` for the wide layers, ``convt4x4s2_band_emulate``
for the narrow ones), against the plain version and the JAX package's
Pallas kernel (interpret mode), and the route rule that sends every bf16
layer of both G-224 ladders to one of them.

Each emulation walks its CUDA kernel's grid with the kernel's index
arithmetic, stores into and reads back from shared memory by the kernel's
(swizzled) addresses, the ``ldmatrix`` lane addresses and the wgmma
descriptors, and places each thread's accumulator registers by the
kernel's epilogue mapping; it raises if an output element is not written
exactly once. The kernels themselves are held against the plain version on
the card (``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
Tolerances: rtol = atol = 2e-4 in f32 (sums in another order); in bf16
2**-7 * (1 + max|ref|), as ``chip_smoke.py`` holds the kernels (the two may
round one f32 sum to neighbouring bf16 values)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from xgan.ops.pallas.convt import convt4x4s2_fused as pallas_convt
from xgan_torch.kernels.convt import (Route, band_rows,
                                      convt4x4s2_band_emulate,
                                      convt4x4s2_fused_ref,
                                      convt4x4s2_wgmma_emulate, convt_route,
                                      pack_convt_weight)
from xgan_torch.models.convert import convt_hwio_to_torch

torch.set_num_threads(1)

# (H, Cin, Cout) of the five k4s2 layers of each G-224 ladder (fg 64)
G224 = [(7, 512, 256), (14, 256, 128), (28, 128, 64), (56, 64, 32),
        (112, 32, 3)]
WGAN224 = [(7, 1024, 512), (14, 512, 256), (28, 256, 128), (56, 128, 64),
           (112, 64, 3)]
ACTS = ["none", "relu", "leaky_relu"]


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


def _plant_non_finite(x):
    """NaN, +inf and -inf in one channel of three pixels of ``x`` (B, H, W,
    Cin), apart: the first image's top right and bottom left, the last
    image's middle (at H = 9 and 4-row bands the first row of a band and
    the halo of the one before)."""
    b, h, w, cin = x.shape
    x[0, 0, w - 1, 1 % cin] = float("nan")
    x[0, h - 1, 0, 3 % cin] = float("inf")
    x[b - 1, h // 2, w // 2, 7 % cin] = float("-inf")


def _assert_matches_non_finite(got, want, tol):
    """NaN where ``want`` has NaN, the same infinities, and the finite
    values within ``tol`` (an absolute bound)."""
    got, want = got.float(), want.float()
    nan, inf, fin = want.isnan(), want.isinf(), want.isfinite()
    assert nan.any() and inf.any() and fin.any()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    assert (got[fin] - want[fin]).abs().max().item() <= tol


def _against_plain(emulate, shape, **kw):
    """The emulation at every act against the plain version (f32)."""
    args = _torch_args(*_inputs(shape, seed=sum(shape)))
    for act in ACTS:
        got = emulate(*args, act=act, **kw)
        assert got.shape == (shape[0], 2 * shape[1], 2 * shape[2], shape[4])
        np.testing.assert_allclose(
            got.numpy(), convt4x4s2_fused_ref(*args, act).numpy(),
            rtol=2e-4, atol=2e-4, err_msg=act)


# ---- Part 1: the wide layers (csrc/convt4x4s2_wgmma.cu) -------------------

# (B, H, W, Cin, Cout), block_n: every block_n (32: the 64-byte swizzle;
# 64-256: the 128-byte one, 256 in four atoms), a ragged M inside one
# m-tile (75 rows) and across two (135), H != W, Cin = 32 (two taps a
# K-chunk of 64), Cout 40 (not a multiple of its block_n) and two n-tiles
WGMMA_CASES = [((3, 5, 5, 32, 32), 32), ((3, 5, 9, 32, 40), 64),
               ((2, 3, 5, 64, 64), 64), ((1, 4, 3, 64, 256), 128),
               ((1, 3, 3, 32, 256), 256), ((1, 2, 3, 32, 512), 256)]


@pytest.mark.parametrize("shape,block_n", WGMMA_CASES,
                         ids=[f"{s}-bn{n}" for s, n in WGMMA_CASES])
def test_wgmma_emulation_matches_plain(shape, block_n):
    _against_plain(convt4x4s2_wgmma_emulate, shape, block_n=block_n)


@pytest.mark.parametrize("act", ["relu", "none"])
def test_wgmma_emulation_bf16(act):
    """bf16 operands, f32 sums, one rounding to bf16 after the epilogue."""
    args = _torch_args(*_inputs((2, 3, 5, 64, 40), seed=7),
                       dtype=torch.bfloat16)
    got = convt4x4s2_wgmma_emulate(*args, act=act)
    want = convt4x4s2_fused_ref(*args, act)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    tol = 2 ** -7 * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_wgmma_emulation_rejects_shapes_without_a_tile():
    for shape in [(1, 2, 2, 48, 32), (1, 2, 2, 32, 12), (1, 2, 2, 32, 36)]:
        args = _torch_args(*_inputs(shape, seed=1))
        with pytest.raises(ValueError, match="no wgmma tile"):
            convt4x4s2_wgmma_emulate(*args)
    args = _torch_args(*_inputs((1, 2, 2, 32, 32), seed=1))
    with pytest.raises(ValueError, match="no wgmma tile"):
        convt4x4s2_wgmma_emulate(*args, block_n=16)


# ---- Part 2: the narrow layers (csrc/convt4x4s2_band.cu) ------------------

# (B, H, W, Cin, Cout), rows, grid: Cout 3 and 8 (the four phases in one
# product of 16 and 32 columns: the 32- and 64-byte swizzles) and 17, 32
# (a product per phase), a band of rows that does not divide H (the last
# band short), B = 1, a ragged last slab, Cin 32 and 64, more blocks than
# items and fewer
BAND_CASES = [((1, 5, 7, 32, 3), 2, 3), ((2, 5, 6, 64, 32), 2, 3),
              ((1, 7, 4, 64, 8), 3, 2), ((2, 3, 9, 32, 3), None, 1),
              ((1, 4, 5, 64, 17), None, 8), ((1, 9, 3, 64, 32), 4, 2),
              ((1, 6, 5, 64, 4), 4, 2), ((1, 3, 7, 32, 6), None, 1)]


@pytest.mark.parametrize("shape,rows,grid", BAND_CASES,
                         ids=[f"{s}-r{r}-g{g}" for s, r, g in BAND_CASES])
def test_band_emulation_matches_plain(shape, rows, grid):
    _against_plain(convt4x4s2_band_emulate, shape, rows=rows, grid=grid)


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("cout", [3, 32])
def test_band_emulation_bf16(cout, act):
    args = _torch_args(*_inputs((1, 5, 6, 64, cout), seed=cout),
                       dtype=torch.bfloat16)
    got = convt4x4s2_band_emulate(*args, act=act, rows=2)
    want = convt4x4s2_fused_ref(*args, act)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    tol = 2 ** -7 * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_band_emulation_rejects_bands_that_do_not_fit():
    args = _torch_args(*_inputs((1, 4, 4, 128, 3), seed=2))
    with pytest.raises(ValueError, match="no band"):
        convt4x4s2_band_emulate(*args, rows=1)  # Cin 128
    args = _torch_args(*_inputs((1, 4, 70, 64, 32), seed=2))
    with pytest.raises(ValueError, match="no band"):
        convt4x4s2_band_emulate(*args, rows=2)  # 140 pixels > 2 slabs


def test_band_rows():
    """The ladders' narrow layers take 4-row bands at 112 (7 of 8 slabs)
    and 2-row bands at 56 (Cout 32: 2 slabs, the output span within the
    band); shapes the kernel cannot hold take none."""
    assert band_rows(112, 112, 64, 3) == 4
    assert band_rows(112, 112, 32, 3) == 4
    assert band_rows(56, 56, 64, 32) == 2
    assert band_rows(3, 5, 64, 3) == 3  # all of H
    assert band_rows(4, 4, 128, 3) == 0  # Cin 128
    assert band_rows(4, 4, 64, 33) == 0  # Cout above 32
    assert band_rows(4, 600, 64, 3) == 0  # W wider than the slabs
    assert band_rows(56, 56, 32, 32) == 0  # the span would not fit


# ---- both against the JAX package's Pallas kernel --------------------------

# one act each (the Pallas kernel compiles per call in interpret mode):
# ragged M and H != W on both kernels, Cin = 32 with two n-tiles, a short
# last band with Cout 32
PALLAS_CASES = [("wgmma", (3, 5, 9, 32, 40), "leaky_relu", {}),
                ("wgmma", (1, 2, 3, 32, 512), "relu", {"block_n": 256}),
                ("band", (1, 5, 7, 32, 3), "none", {"rows": 2}),
                ("band", (1, 9, 3, 64, 32), "relu", {"rows": 4})]


@pytest.mark.parametrize("kernel,shape,act,kw", PALLAS_CASES,
                         ids=[f"{k}-{s}-{a}" for k, s, a, _ in PALLAS_CASES])
def test_emulation_matches_pallas(kernel, shape, act, kw):
    x, w_hwio, scale, shift = _inputs(shape, seed=sum(shape) + 1)
    emulate = (convt4x4s2_wgmma_emulate if kernel == "wgmma"
               else convt4x4s2_band_emulate)
    got = emulate(*_torch_args(x, w_hwio, scale, shift), act=act, **kw)
    pallas = np.asarray(pallas_convt(
        jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(scale),
        jnp.asarray(shift), act=act, interpret=True))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4, atol=2e-4)


# ---- inputs that are not finite --------------------------------------------

# (B, H, W, Cin, Cout), kw: wgmma; the band kernel with the four phases in
# one product (Cout 3 and 8, halo rows and a short last band) and with a
# product a phase (Cout 32)
NONFINITE_CASES = [("wgmma", (2, 3, 5, 32, 40), {}),
                   ("band", (1, 9, 7, 32, 3), {"rows": 4}),
                   ("band", (2, 5, 6, 64, 8), {"rows": 2}),
                   ("band", (1, 5, 7, 64, 32), {"rows": 2})]


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("kernel,shape,kw", NONFINITE_CASES,
                         ids=[f"{k}-{s}" for k, s, _ in NONFINITE_CASES])
def test_emulation_keeps_non_finite_values(kernel, shape, kw, act):
    """NaN and +-inf planted in x come out as the plain version has them:
    NaN stays NaN under every act, relu(-inf) is 0; the band kernel's
    shared products (a zero column times inf or NaN) do not spread NaN."""
    x, w_hwio, scale, shift = _inputs(shape, seed=sum(shape) + 5)
    _plant_non_finite(x)
    args = _torch_args(x, w_hwio, scale, shift)
    emulate = (convt4x4s2_wgmma_emulate if kernel == "wgmma"
               else convt4x4s2_band_emulate)
    got = emulate(*args, act=act, **kw)
    want = convt4x4s2_fused_ref(*args, act)
    _assert_matches_non_finite(got, want, 2e-4 * (1 + want[
        want.isfinite()].abs().max().item()))


# ---- the route --------------------------------------------------------------

# (H, Cin, Cout) -> (design, block_n): the tile each layer of both G-224
# ladders measured fastest on an H100 at B = 64 and 128 (PERF.md §6)
LADDER_ROUTES = {
    (7, 512, 256): ("wgmma", 256), (14, 256, 128): ("wgmma", 128),
    (28, 128, 64): ("wgmma", 64), (56, 64, 32): ("band", 32),
    (112, 32, 3): ("band", 4),
    (7, 1024, 512): ("wgmma", 256), (14, 512, 256): ("wgmma", 256),
    (28, 256, 128): ("wgmma", 128), (56, 128, 64): ("wgmma", 64),
    (112, 64, 3): ("band", 4)}


@pytest.mark.parametrize("layer", G224 + WGAN224,
                         ids=[f"{h}-{ci}-{co}" for h, ci, co in G224 + WGAN224])
def test_route_of_every_ladder_layer(layer):
    """bf16: each layer of both ladders on the wgmma or band kernel at the
    tile measured fastest, the band at the most rows that fit; f32 on the
    CUDA-core kernel."""
    h, cin, cout = layer
    design, block_n = LADDER_ROUTES[layer]
    assert convt_route(torch.bfloat16, h, h, cin, cout) == Route(
        design, block_n, band_rows(h, h, cin, cout) if design == "band"
        else 0)
    assert convt_route(torch.float32, h, h, cin, cout) \
        == Route("core", 0, 0)


def test_route_rule_off_the_ladders():
    """Shapes off the ladders: band for Cout <= 32 where a band fits,
    wgmma for Cout % 8 == 0 and >= 32, mma.sync otherwise; the CUDA-core
    kernel for Cin % 32 != 0 and f32."""
    bf = torch.bfloat16
    assert convt_route(bf, 9, 17, 64, 3) == Route("band", 4, 9)
    assert convt_route(bf, 9, 17, 64, 8) == Route("band", 8, 9)
    assert convt_route(bf, 11, 13, 32, 17) \
        == Route("band", 32, band_rows(11, 13, 32, 17))
    assert convt_route(bf, 5, 9, 512, 40) == Route("wgmma", 64, 0)
    assert convt_route(bf, 3, 3, 32, 32) == Route("band", 32, 1)
    assert convt_route(bf, 56, 56, 32, 32) == Route("wgmma", 32, 0)  # no band
    assert convt_route(bf, 4, 4, 64, 1024) == Route("wgmma", 256, 0)
    assert convt_route(bf, 7, 7, 512, 8) == Route("mma", 8, 0)  # Cin 512
    assert convt_route(bf, 7, 7, 512, 3) == Route("mma", 8, 0)
    assert convt_route(bf, 7, 7, 128, 36) == Route("mma", 64, 0)
    assert convt_route(bf, 7, 7, 48, 64).design == "core"
    assert convt_route(torch.float32, 7, 7, 64, 64).design == "core"
