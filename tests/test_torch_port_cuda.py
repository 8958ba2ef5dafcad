"""xgan_torch's CUDA kernels on the card: each against its plain version
at small and odd shapes, and the op's argument checks. Marked ``cuda``;
they skip on a host without a CUDA device. Run on the card with

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda
"""
import contextlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from xgan_torch import kernels
from xgan_torch.kernels.convt import (convt4x4s2_fused,
                                      convt4x4s2_fused_cuda,
                                      convt4x4s2_fused_ref, mma_tiles,
                                      pack_convt_weight)
from xgan_torch.kernels.gather import (mixed_gather, mixed_gather_cuda,
                                      mixed_gather_ref, new_error_flag,
                                      raise_if_flagged)
from xgan_torch.models.dcgan import Generator

pytestmark = pytest.mark.cuda

# f32: sums in another order than the plain version; bf16: the two may
# round the same f32 sum to neighbouring bf16 values (2**-8 relative).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(shape, dtype, dev, seed=0):
    """``shape``: (B, H, Cin, Cout) for a square input or (B, H, W, Cin,
    Cout)."""
    b, *hw, cin, cout = shape
    h, w = hw * 2 if len(hw) == 1 else hw
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=g, device=dev).to(dtype)
    w = torch.randn(cin, cout, 4, 4, generator=g, device=dev) \
        / (4 * cin) ** 0.5
    scale = torch.rand(cout, generator=g, device=dev) + 0.5
    shift = 0.1 * torch.randn(cout, generator=g, device=dev)
    return x, pack_convt_weight(w, dtype), scale, shift


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 5, 100, 3),
                                   (2, 7, 512, 8), (1, 9, 6, 33)])
def test_kernel_matches_plain(dev, shape, dtype, act):
    args = _inputs(shape, dtype, dev)
    kernels.reset_launch_counts()
    got = convt4x4s2_fused(*args, act=act)
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 1
    want = convt4x4s2_fused_ref(*args, act=act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    tol = TOL[dtype] * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


# (B, H, W, Cin, Cout): the five G-224 layers at B = 2, then a ragged M
# (75 rows), H != W with Cout = 40 (not a multiple of its block_n, 64), and
# Cout = 3 with two m-tiles
MMA_SHAPES = [(2, 7, 7, 512, 256), (2, 14, 14, 256, 128),
              (2, 28, 28, 128, 64), (2, 56, 56, 64, 32),
              (2, 112, 112, 32, 3), (3, 5, 5, 32, 32), (2, 4, 6, 32, 40),
              (1, 9, 17, 64, 3)]


@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
@pytest.mark.parametrize("shape", MMA_SHAPES)
def test_convt_mma_route_matches_plain(dev, shape, act):
    """bf16 with Cin % 32 == 0 launches the tensor-core kernel."""
    args = _inputs(shape, torch.bfloat16, dev)
    kernels.reset_launch_counts()
    got = convt4x4s2_fused(*args, act=act)
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 1
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 1
    want = convt4x4s2_fused_ref(*args, act=act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    tol = TOL[torch.bfloat16] * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def test_convt_mma_route_rejects_misaligned_x(dev):
    """A bf16 x one element into its storage still takes the tensor-core
    route, whose op raises: no fallback to the CUDA-core kernel."""
    x, wp, scale, shift = _inputs((2, 4, 32, 8), torch.bfloat16, dev)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = base[1:].view(x.shape)
    shifted.copy_(x)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="16-byte"):
        convt4x4s2_fused(shifted, wp, scale, shift, act="relu")
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 0
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 0


def test_convt_mma_op_checks_its_arguments(dev):
    from xgan_torch.kernels.build import load_ops
    ops = load_ops()
    x, wp, scale, shift = _inputs((2, 4, 64, 8), torch.bfloat16, dev)
    x48, wp48, _, _ = _inputs((2, 4, 48, 8), torch.bfloat16, dev)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = base[1:].view(x.shape)
    shifted.copy_(x)
    bn = mma_tiles(64, 8).block_n
    bad = [
        ((x.float(), wp.float(), scale, shift, 1, bn), "bfloat16"),
        ((x48, wp48, scale, shift, 1, bn), "multiple of 32"),
        ((shifted, wp, scale, shift, 1, bn), "16-byte"),
        ((x, wp, scale, shift, 1, 16), "block_n"),
        ((x, wp, scale, shift, 3, bn), "act"),
    ]
    kernels.reset_launch_counts()
    for args, what in bad:
        with pytest.raises(RuntimeError, match=what):
            ops.convt4x4s2_mma(*args)
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 0  # the op counts nothing
    got = ops.convt4x4s2_mma(x, wp, scale, shift, 1, bn).float()
    want = convt4x4s2_fused_ref(x, wp, scale, shift, "relu").float()
    tol = TOL[torch.bfloat16] * (1 + want.abs().max().item())
    assert (got - want).abs().max().item() <= tol


# (B, H, W, Cin, Cout): both G-224 ladders at B = 2 (the DCGAN one also
# at B = 1), then the edges: ragged M, H != W, Cout 8, 40 and 3 at a wide
# Cin (the route sends 8 and 3 there to mma.sync), Cin 32 at Cout 32 (a
# one-row band) and at Cout 64 (wgmma, two taps a K-chunk, ragged M), a
# band of rows that does not divide H
WGMMA_LADDER = [(7, 512, 256), (14, 256, 128), (28, 128, 64), (56, 64, 32),
                (112, 32, 3), (7, 1024, 512), (14, 512, 256),
                (28, 256, 128), (56, 128, 64), (112, 64, 3)]
WGMMA_SHAPES = ([(2, h, h, cin, cout) for h, cin, cout in WGMMA_LADDER]
                + [(1, h, h, cin, cout) for h, cin, cout in WGMMA_LADDER[:5]]
                + [(3, 5, 5, 64, 64), (2, 6, 10, 256, 128), (1, 9, 17, 64, 3),
                   (2, 7, 7, 512, 8), (1, 5, 9, 512, 40), (2, 7, 7, 512, 3),
                   (3, 5, 5, 32, 32), (1, 11, 13, 32, 17), (2, 13, 6, 64, 32),
                   (3, 5, 5, 32, 64)])


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", WGMMA_SHAPES)
def test_convt_route_matches_plain(dev, shape, act):
    """bf16 through ``convt4x4s2_fused``: the design ``convt_route`` names
    launches once (and counts as a tensor-core launch)."""
    from xgan_torch.kernels.convt import convt_route
    b, h, w, cin, cout = shape
    args = _inputs(shape, torch.bfloat16, dev)
    route = convt_route(torch.bfloat16, h, w, cin, cout)
    kernels.reset_launch_counts()
    got = convt4x4s2_fused(*args, act=act)
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 1
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 1
    assert kernels.LAUNCHES["convt4x4s2_wgmma"] == (route.design == "wgmma")
    assert kernels.LAUNCHES["convt4x4s2_band"] == (route.design == "band")
    want = convt4x4s2_fused_ref(*args, act=act)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    tol = TOL[torch.bfloat16] * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _plant_non_finite(x):
    """NaN, +inf and -inf in one channel of three pixels of ``x`` (B, H, W,
    Cin), apart: the first image's top right and bottom left, the last
    image's row min(H - 1, 12) (at H = 20 and 12-row bands the first row
    of a band and the halo of the one before)."""
    b, h, w, cin = x.shape
    x[0, 0, w - 1, 1 % cin] = float("nan")
    x[0, h - 1, 0, 3 % cin] = float("inf")
    x[b - 1, min(h - 1, 12), w // 2, 7 % cin] = float("-inf")


# (B, H, W, Cin, Cout): wgmma; the band kernel with the four phases in one
# product (Cout 3 over two bands, Cout 8) and a product a phase (Cout 32);
# mma.sync (Cout 3 at Cin 512)
NONFINITE_SHAPES = [(2, 7, 7, 128, 64), (1, 20, 40, 32, 3), (2, 9, 17, 64, 8),
                    (2, 13, 6, 64, 32), (2, 7, 7, 512, 3)]


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", NONFINITE_SHAPES)
def test_convt_routes_keep_non_finite_values(dev, shape, act):
    """NaN and +-inf planted in x come out of each bf16 route as the plain
    version has them: NaN stays NaN under every act, relu(-inf) is 0, and
    the band kernel's shared products do not spread NaN."""
    x, wp, scale, shift = _inputs(shape, torch.bfloat16, dev, seed=3)
    _plant_non_finite(x)
    got = convt4x4s2_fused(x, wp, scale, shift, act=act).float()
    want = convt4x4s2_fused_ref(x, wp, scale, shift, act=act).float()
    torch.cuda.synchronize()
    nan, inf, fin = want.isnan(), want.isinf(), want.isfinite()
    assert nan.any() and inf.any() and fin.any()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    tol = TOL[torch.bfloat16] * (1 + want[fin].abs().max().item())
    assert (got[fin] - want[fin]).abs().max().item() <= tol


@pytest.mark.parametrize("act", ["none", "relu", "leaky_relu"])
@pytest.mark.parametrize("shape", NONFINITE_SHAPES)
def test_f32_convt_route_keeps_non_finite_values(dev, shape, act):
    """The same planted NaN and +-inf through the f32 CUDA-core kernel
    (csrc/convt4x4s2.cu): NaN stays NaN under every act (an fmaxf relu
    made it 0), relu(-inf) is 0, +-inf where the plain version has it."""
    x, wp, scale, shift = _inputs(shape, torch.float32, dev, seed=3)
    _plant_non_finite(x)
    kernels.reset_launch_counts()
    got = convt4x4s2_fused(x, wp, scale, shift, act=act)
    want = convt4x4s2_fused_ref(x, wp, scale, shift, act=act)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 1
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 0
    nan, inf, fin = want.isnan(), want.isinf(), want.isfinite()
    assert nan.any() and inf.any() and fin.any()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(got.isinf(), inf) and torch.equal(got[inf], want[inf])
    tol = TOL[torch.float32] * (1 + want[fin].abs().max().item())
    assert (got[fin] - want[fin]).abs().max().item() <= tol


def test_non_finite_shapes_cover_the_f32_route():
    from xgan_torch.kernels.convt import convt_route, uses_mma
    for _, h, w, cin, cout in NONFINITE_SHAPES:
        assert not uses_mma(torch.float32, cin)
        assert convt_route(torch.float32, h, w, cin, cout).design == "core"


def test_non_finite_shapes_cover_every_bf16_route():
    from xgan_torch.kernels.convt import band_np, convt_route
    routes = [convt_route(torch.bfloat16, h, w, cin, cout)
              for _, h, w, cin, cout in NONFINITE_SHAPES]
    assert {r.design for r in routes} == {"wgmma", "band", "mma"}
    assert {band_np(s[-1]) for s, r in zip(NONFINITE_SHAPES, routes)
            if r.design == "band"} == {4, 8, 32}


def _on_a_new_design(shape):
    from xgan_torch.kernels.convt import band_rows
    _, h, w, cin, cout = shape
    return (cin % 32 == 0 and cout % 8 == 0 and cout >= 32) \
        or band_rows(h, w, cin, cout) > 0


# the shapes either warpgroup kernel takes (not the mma.sync ones)
@pytest.mark.parametrize("shape", [s for s in WGMMA_SHAPES[:10]
                                   + WGMMA_SHAPES[15:] if _on_a_new_design(s)])
def test_convt_wgmma_and_band_ops_at_every_tile(dev, shape):
    """Each op called directly at every tile it takes for the shape: the
    wgmma kernel at each block_n, the band kernel at the table's rows, at
    one row and at a row count that does not divide H."""
    from xgan_torch.kernels.build import load_ops
    from xgan_torch.kernels.convt import WGMMA_BLOCK_NS, band_rows
    ops = load_ops()
    b, h, w, cin, cout = shape
    x, wp, scale, shift = _inputs(shape, torch.bfloat16, dev, seed=1)
    want = convt4x4s2_fused_ref(x, wp, scale, shift, act="relu").float()
    tol = TOL[torch.bfloat16] * (1 + want.abs().max().item())
    runs = []
    if cin % 32 == 0 and cout % 8 == 0 and cout >= 32:
        runs += [lambda n=n: ops.convt4x4s2_wgmma(x, wp, scale, shift, 1, n)
                 for n in WGMMA_BLOCK_NS]
    rows = band_rows(h, w, cin, cout)
    if rows:
        runs += [lambda r=r: ops.convt4x4s2_band(x, wp, scale, shift, 1, r)
                 for r in sorted({rows, 1, max(1, (rows + 1) // 2)})]
    assert runs
    kernels.reset_launch_counts()
    for run in runs:
        got = run().float()
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= tol
    assert not kernels.LAUNCHES  # the ops count nothing


def test_convt_wgmma_op_checks_its_arguments(dev):
    from xgan_torch.kernels.build import load_ops
    ops = load_ops()
    x, wp, scale, shift = _inputs((2, 4, 64, 64), torch.bfloat16, dev)
    x48, wp48, _, _ = _inputs((2, 4, 48, 64), torch.bfloat16, dev)
    _, wp24, s24, h24 = _inputs((2, 4, 64, 24), torch.bfloat16, dev)
    _, wp36, s36, h36 = _inputs((2, 4, 64, 36), torch.bfloat16, dev)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = base[1:].view(x.shape)
    shifted.copy_(x)
    bad = [
        ((x.float(), wp.float(), scale, shift, 1, 64), "bfloat16"),
        ((x48, wp48, scale, shift, 1, 64), "multiple of 32"),
        ((x, wp24, s24, h24, 1, 32), "at least 32"),
        ((x, wp36, s36, h36, 1, 64), "multiple of 8"),
        ((shifted, wp, scale, shift, 1, 64), "16-byte"),
        ((x, wp, scale, shift, 1, 16), "block_n"),
        ((x, wp, scale, shift, 3, 64), "act"),
    ]
    for args, what in bad:
        with pytest.raises(RuntimeError, match=what):
            ops.convt4x4s2_wgmma(*args)


def test_convt_band_op_checks_its_arguments(dev):
    from xgan_torch.kernels.build import load_ops
    ops = load_ops()
    x, wp, scale, shift = _inputs((2, 8, 64, 3), torch.bfloat16, dev)
    x128, wp128, _, _ = _inputs((2, 8, 128, 3), torch.bfloat16, dev)
    _, wp40, s40, h40 = _inputs((2, 8, 64, 40), torch.bfloat16, dev)
    wide, wpw, sw_, hw_ = _inputs((1, 2, 70, 64, 32), torch.bfloat16, dev)
    base = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)
    shifted = base[1:].view(x.shape)
    shifted.copy_(x)
    bad = [
        ((x.float(), wp.float(), scale, shift, 1, 2), "bfloat16"),
        ((x128, wp128, scale, shift, 1, 2), "Cin must be 32 or 64"),
        ((x, wp40, s40, h40, 1, 2), "Cout must be 1 to 32"),
        ((x, wp, scale, shift, 1, 0), "rows must be at least 1"),
        ((wide, wpw, sw_, hw_, 1, 2), "rows \\* W"),
        ((shifted, wp, scale, shift, 1, 2), "16-byte"),
        ((x, wp, scale, shift, 3, 2), "act"),
    ]
    for args, what in bad:
        with pytest.raises(RuntimeError, match=what):
            ops.convt4x4s2_band(*args)


def test_op_checks_its_arguments(dev):
    x, wp, scale, shift = _inputs((2, 4, 8, 5), torch.float32, dev)
    bad = [
        (x.transpose(1, 2), wp, scale, shift, "relu"),  # not contiguous
        (x.half(), wp.half(), scale, shift, "relu"),  # dtype
        (x, wp.bfloat16(), scale, shift, "relu"),  # weight dtype
        (x[..., :7].contiguous(), wp, scale, shift, "relu"),  # Cin
        (x, wp, scale[:4], shift, "relu"),  # scale length
        (x, wp, scale.double(), shift, "relu"),  # scale dtype
    ]
    for args in bad:
        with pytest.raises(RuntimeError):
            convt4x4s2_fused_cuda(*args)
    from xgan_torch.kernels.build import load_ops
    with pytest.raises(RuntimeError, match="act"):
        load_ops().convt4x4s2_fused(x, wp, scale, shift, 3)


def test_generator_on_card_matches_cpu(dev):
    """f32 eval forward: kernel path on the card vs plain path on the CPU,
    with unit-gain random weights and random running statistics."""
    g_cpu = Generator(16, 3, 8, 64)
    rng = np.random.default_rng(0)
    sd = {}
    for k, v in g_cpu.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
            continue
        if k.endswith("running_var"):
            r = 0.5 + rng.random(v.shape)
        elif v.dim() == 4:  # ConvT (Cin, Cout, k, k): unit gain
            fan = v.shape[0] * (1 if k == "main.0.weight" else 4)
            r = rng.normal(size=v.shape) * (2.0 / fan) ** 0.5
        else:  # BN weight 1 + 0.1 N; bias and running mean 0.1 N
            r = k.endswith(".weight") + 0.1 * rng.normal(size=v.shape)
        sd[k] = torch.from_numpy(np.asarray(r, np.float32))
    g_cpu.load_state_dict(sd)
    g_gpu = Generator(16, 3, 8, 64, device=dev)
    g_gpu.load_state_dict(sd)
    z = torch.from_numpy(rng.normal(size=(5, 16)).astype(np.float32))
    kernels.reset_launch_counts()
    got = g_gpu(z.to(dev))
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 5
    want = g_cpu(z)
    assert want.std() > 0.1
    assert (got.cpu() - want).abs().max().item() <= 2e-4


def _gather_inputs(dev, nr, ns, b, s, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    real = torch.randint(0, 256, (nr, s, s, 3), generator=g, device=dev,
                         dtype=torch.uint8)
    synth = torch.randint(0, 256, (ns, s, s, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    ridx = torch.randint(0, nr, (b,), generator=g, device=dev)
    sidx = torch.randint(0, ns, (b,), generator=g, device=dev)
    mask = torch.rand(b, generator=g, device=dev) < 0.5
    return real, synth, ridx, sidx, mask


@pytest.mark.parametrize("nr,ns,b,s", [(10, 4, 8, 32), (7, 3, 5, 33),
                                       (3, 2, 1, 1), (64, 16, 32, 224),
                                       (5, 5, 9, 75)])
def test_gather_kernel_matches_plain(dev, nr, ns, b, s):
    """Bitwise, at aligned (S % 4 == 0) and unaligned row sizes, with the
    mask mixed, all real and all synthetic."""
    real, synth, ridx, sidx, mask = _gather_inputs(dev, nr, ns, b, s)
    for m in (mask, torch.zeros_like(mask), torch.ones_like(mask)):
        kernels.reset_launch_counts()
        got = mixed_gather(real, synth, ridx, sidx, m)
        assert kernels.LAUNCHES["mixed_gather"] == 1
        want = mixed_gather_ref(real, synth, ridx, sidx, m)
        assert got.shape == (b, s, s, 3) and got.dtype == torch.uint8
        assert torch.equal(got, want)


def test_gather_kernel_from_unaligned_views(dev):
    """A store that starts 1 byte into its storage takes the byte path."""
    real, synth, ridx, sidx, mask = _gather_inputs(dev, 6, 4, 8, 32)
    base = torch.zeros(real.numel() + 1, dtype=torch.uint8, device=dev)
    shifted = base[1:].view(real.shape)
    shifted.copy_(real)
    got = mixed_gather(shifted, synth, ridx, sidx, mask)
    assert torch.equal(got, mixed_gather_ref(real, synth, ridx, sidx, mask))


def test_gather_kernel_bad_index_raises(dev):
    real, synth, ridx, sidx, mask = _gather_inputs(dev, 6, 4, 8, 32)
    for r, s in ((ridx.clone().fill_(6), sidx), (ridx, sidx - 5)):
        with pytest.raises(IndexError):
            mixed_gather(real, synth, r, s, mask)
    # a shared flag: the launch returns, the read raises
    err = new_error_flag(dev)
    mixed_gather(real, synth, ridx, sidx, mask, err=err)
    raise_if_flagged(err)
    mixed_gather(real, synth, ridx + 100, sidx, mask, err=err)
    with pytest.raises(IndexError):
        raise_if_flagged(err)


def test_gather_op_checks_its_arguments(dev):
    real, synth, ridx, sidx, mask = _gather_inputs(dev, 6, 4, 8, 32)
    bad = [
        (real.float(), synth, ridx, sidx, mask),  # store dtype
        (real, synth[:, :16].contiguous(), ridx, sidx, mask),  # S
        (real, synth, ridx.int(), sidx, mask),  # index dtype
        (real, synth, ridx, sidx, mask.int()),  # mask dtype
        (real, synth, ridx[:4], sidx, mask),  # lengths
        (real.transpose(1, 2), synth, ridx, sidx, mask),  # contiguity
    ]
    for args in bad:
        with pytest.raises(RuntimeError):
            mixed_gather_cuda(*args)


@pytest.mark.parametrize("mode,freeze", [("mix", True), ("concat", False)])
def test_classifier_step_on_card_matches_cpu(dev, mode, freeze):
    """One f32 train step (TF32 off) at stages (1,1,1,1), 32 px, with the
    same weights and draws: the card's kernel path against the CPU's plain
    path; the gather launches once."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.data.store import ImageStore
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.train.classifier import classifier_optimizer, train_step
    rng = np.random.default_rng(1)
    real = ImageStore(rng.integers(0, 255, (12, 32, 32, 3), np.uint8),
                      np.arange(12) % 2, 32)
    synth = ImageStore(rng.integers(0, 255, (5, 32, 32, 3), np.uint8),
                       np.ones(5), 32)
    hi = 12 if mode == "mix" else 17
    idx = torch.from_numpy(rng.integers(0, hi, 8))
    draws = {"flip": torch.from_numpy(rng.random(8) < 0.5),
             "use_synth": torch.from_numpy(rng.random(8) < 0.5),
             "synth_pick": torch.from_numpy(rng.integers(0, 5, 8))}
    init = ResNet50(2, stage_sizes=(1, 1, 1, 1)).state_dict()
    out = {}
    for d in ("cpu", dev):
        model = ResNet50(2, stage_sizes=(1, 1, 1, 1), device=d)
        model.load_state_dict(init)
        opt = classifier_optimizer(model, 1e-3, freeze_base=freeze)
        kernels.reset_launch_counts()
        losses, _, labels = train_step(
            model, opt, DeviceStore(real, d), DeviceStore(synth, d),
            idx.to(d), mode=mode, ratio=0.5,
            **{k: v.to(d) for k, v in draws.items()})
        assert kernels.LAUNCHES["mixed_gather"] == (d != "cpu")
        out[str(d)] = (losses.cpu(), labels.cpu(),
                       model.fc.weight.detach().cpu())
    (l_cpu, y_cpu, w_cpu), (l_dev, y_dev, w_dev) = out.values()
    assert torch.equal(y_cpu, y_dev)
    assert (l_cpu - l_dev).abs().max() <= 1e-4 * (1 + l_cpu.abs().max())
    assert (w_cpu - w_dev).abs().max() <= 1e-4


# (B, H, Cin, Cout, dtype): f32 on the CUDA-core kernel; bf16 with
# Cin % 32 == 0 on the tensor-core kernel (the G-224 ladder at B = 2)
GAN_CONVT_CASES = [(2, 7, 64, 32, torch.float32), (3, 5, 6, 4, torch.float32),
                   (2, 7, 512, 256, torch.bfloat16),
                   (2, 28, 128, 64, torch.bfloat16),
                   (2, 112, 32, 3, torch.bfloat16)]
# bf16 through each design of the table: wgmma (DCGAN 1 and 4 wide, WGAN-GP
# 1), band (DCGAN 4 and 5, WGAN-GP 5)
GAN_CONVT_ROUTES = [(2, 7, 512, 256), (2, 56, 64, 32), (2, 112, 32, 3),
                    (2, 7, 1024, 512), (2, 56, 128, 64), (2, 112, 64, 3)]


@pytest.mark.parametrize("case", GAN_CONVT_CASES)
def test_gan_convt_train_matches_conv_transpose2d(dev, case):
    """Forward and both gradients of ``convt4x4s2_train`` on the card
    against ``F.conv_transpose2d`` under autograd, on the same operands
    (bf16: the weight rounded to bf16 for both)."""
    import torch.nn.functional as F
    from xgan_torch.kernels.convt import convt4x4s2_train
    b, h, cin, cout, dtype = case
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(b, h, h, cin, generator=g, device=dev).to(dtype)
    w = torch.randn(cin, cout, 4, 4, generator=g, device=dev) \
        / (4 * cin) ** 0.5
    up = torch.randn(b, 2 * h, 2 * h, cout, generator=g, device=dev) \
        .to(dtype)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    kernels.reset_launch_counts()
    y = convt4x4s2_train(xa, wa)
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 1
    assert kernels.LAUNCHES["convt4x4s2_mma"] == (dtype == torch.bfloat16)
    dx, dw = torch.autograd.grad(y, (xa, wa), up)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_ref = F.conv_transpose2d(xb.permute(0, 3, 1, 2), wb.to(dtype),
                               stride=2, padding=1).permute(0, 2, 3, 1)
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (xb, wb), up)
    torch.cuda.synchronize()
    assert y.dtype == dx.dtype == dtype and dw.dtype == torch.float32
    for got, want in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        want = want.float()
        tol = TOL[dtype] * (1 + want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= tol


@pytest.mark.parametrize("case", GAN_CONVT_ROUTES)
def test_gan_convt_train_through_the_table_routes(dev, case):
    """``convt4x4s2_train`` (the kernel forward, act none, cuDNN backward)
    through the wgmma and band kernels against ``F.conv_transpose2d``
    under autograd: forward and both gradients."""
    import torch.nn.functional as F
    from xgan_torch.kernels.convt import convt4x4s2_train, convt_route
    b, h, cin, cout = case
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(b, h, h, cin, generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn(cin, cout, 4, 4, generator=g, device=dev) \
        / (4 * cin) ** 0.5
    up = torch.randn(b, 2 * h, 2 * h, cout, generator=g, device=dev) \
        .to(torch.bfloat16)
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    design = convt_route(torch.bfloat16, h, h, cin, cout).design
    kernels.reset_launch_counts()
    y = convt4x4s2_train(xa, wa)
    assert kernels.LAUNCHES[f"convt4x4s2_{design}"] == 1
    dx, dw = torch.autograd.grad(y, (xa, wa), up)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    y_ref = F.conv_transpose2d(xb.permute(0, 3, 1, 2), wb.to(torch.bfloat16),
                               stride=2, padding=1).permute(0, 2, 3, 1)
    dx_ref, dw_ref = torch.autograd.grad(y_ref, (xb, wb), up)
    torch.cuda.synchronize()
    for got, want in ((y, y_ref), (dx, dx_ref), (dw, dw_ref)):
        want = want.float()
        tol = TOL[torch.bfloat16] * (1 + want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= tol


def _gan_models(dev, fg, size, dtype):
    from xgan_torch.models.dcgan import Discriminator
    from xgan_torch.train.common import adam
    g_net = Generator(16, 3, fg, size, dtype=dtype, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    d_net = Discriminator(3, 8, size, dtype=dtype, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
    return (g_net, d_net, adam(g_net.parameters(), 2e-4, 0.5),
            adam(d_net.parameters(), 2e-4, 0.5))


def test_gan_step_kernel_matches_plain(dev):
    """One f32 step (TF32 off, deterministic cuDNN) from the same weights
    and draws, with G's k4s2 forwards on the kernel and on the plain
    version: the metrics within 1e-4, the norm of each of G's gradients
    within 1e-3 relative (Adam's first step is ~lr * sign(grad), so the
    weights themselves may differ by lr where a gradient is near 0)."""
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    from xgan_torch.train.gan import dcgan_step
    g = torch.Generator(device=dev).manual_seed(2)
    store = torch.randint(0, 256, (12, 64, 64, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    idx = torch.arange(8, device=dev)
    flip = torch.rand(8, generator=g, device=dev) < 0.5
    noise = torch.randn(8, 16, generator=g, device=dev)
    out = []
    torch.backends.cudnn.deterministic = True  # no atomics in the sums
    try:
        for convt in (None, convt4x4s2_fused_ref):
            g_net, d_net, opt_g, opt_d = _gan_models(dev, 16, 64,
                                                     torch.float32)
            kw = {} if convt is None else {"convt": convt}
            kernels.reset_launch_counts()
            m = dcgan_step(g_net, d_net, opt_g, opt_d, store, idx,
                           latent_dim=16, flip=flip, noise=noise, **kw)
            assert kernels.LAUNCHES["convt4x4s2_fused"] == (
                5 if convt is None else 0)
            out.append((m, [p.grad.norm().item()
                            for p in g_net.parameters()]))
    finally:
        torch.backends.cudnn.deterministic = False
    (m_k, n_k), (m_p, n_p) = out
    assert (m_k - m_p).abs().max().item() <= 1e-4
    for a, b in zip(n_k, n_p):
        assert abs(a - b) <= 1e-3 * b


def test_gan_bf16_step_launches_five_tensor_core_convts(dev):
    """Every k4s2 layer of the bf16 train-mode G (fg 64: each Cin a
    multiple of 32) runs on the tensor-core kernel, once per step."""
    from xgan_torch.train.gan import dcgan_step
    g_net, d_net, opt_g, opt_d = _gan_models(dev, 64, 64, torch.bfloat16)
    store = torch.randint(0, 256, (8, 64, 64, 3), device=dev,
                          dtype=torch.uint8)
    gen = torch.Generator(dev).manual_seed(4)
    kernels.reset_launch_counts()
    for _ in range(2):
        m = dcgan_step(g_net, d_net, opt_g, opt_d, store,
                       torch.arange(8, device=dev), latent_dim=16,
                       dtype=torch.bfloat16, generator=gen)
    assert torch.isfinite(m).all()
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 10
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 10


# ---- the analyzer (f32, TF32 off by the ``dev`` fixture) -----------------

def test_ssim_on_card_matches_cpu(dev):
    """All-pairs SSIM on the card against the CPU within 1e-5: 20 x 10
    images at 224 px (four chunks of products), and the per-synthetic
    mean."""
    from xgan_torch.ops.ssim import mean_ssim_per_synthetic, ssim_pair_matrix
    g = torch.Generator().manual_seed(5)
    real = torch.rand(10, 224, 224, generator=g)
    synth = (0.5 * real[torch.arange(20) % 10]
             + 0.5 * torch.rand(20, 224, 224, generator=g))
    want = ssim_pair_matrix(synth, real)
    got = ssim_pair_matrix(synth.to(dev), real.to(dev)).cpu()
    assert got.shape == (20, 10)
    assert (got - want).abs().max().item() <= 1e-5
    got = mean_ssim_per_synthetic(synth.to(dev), real.to(dev)).cpu()
    assert (got - want.mean(dim=1)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("target", ["conv3", "stage_output"])
def test_grad_cam_on_card_matches_cpu(dev, target):
    """One Grad-CAM map of a full-depth f32 ResNet-50 at 224 px, with
    random BN statistics, on the card against the CPU within 5e-3, with
    the same predicted label."""
    from xgan_torch.analysis import grad_cam_resnet
    from xgan_torch.models.resnet import ResNet50
    g = torch.Generator().manual_seed(6)
    cpu = ResNet50(2, generator=g)
    with torch.no_grad():
        for name, buf in cpu.named_buffers():
            if name.endswith("running_mean"):
                buf.normal_(0, 0.1, generator=g)
            elif name.endswith("running_var"):
                buf.uniform_(0.5, 1.5, generator=g)
    card = ResNet50(2, device=dev)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(224, 224, 3, generator=g)
    pred, cam = grad_cam_resnet(cpu.eval(), x, target=target)
    pred_d, cam_d = grad_cam_resnet(card.eval(), x.to(dev), target=target)
    assert pred_d == pred and cam_d.shape == cam.shape == (7, 7)
    assert np.abs(cam_d - cam).max() <= 5e-3


# ---- WGAN-GP (f32 checks with TF32 off by the ``dev`` fixture) -----------

# (H, Cin, Cout) of the first and last k4s2 layers of the WGAN-GP G-224
# ladder: Cin = 1024 (128 K-chunks a tile) and 64 -> 3 (block_n 8)
WGAN_END_LAYERS = [(7, 1024, 512), (112, 64, 3)]


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("layer", WGAN_END_LAYERS,
                         ids=["1024to512at7", "64to3at112"])
def test_wgan_convt_layers_on_the_mma_route(dev, layer, act):
    """Both end layers of the WGAN-GP ladder at B = 64, bf16, on the
    tensor-core kernel against the plain version."""
    h, cin, cout = layer
    args = _inputs((64, h, cin, cout), torch.bfloat16, dev, seed=h)
    kernels.reset_launch_counts()
    got = convt4x4s2_fused(*args, act=act)
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 1
    want = convt4x4s2_fused_ref(*args, act=act)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (64, 2 * h, 2 * h, cout)
    tol = TOL[torch.bfloat16] * (1 + want.float().abs().max().item())
    assert (got.float() - want.float()).abs().max().item() <= tol


def _wgan_models(dev, fg, size, dtype, seed=0):
    from xgan_torch.models.wgan import Critic
    from xgan_torch.models.wgan import Generator as WGenerator
    from xgan_torch.train.common import adam
    g_net = WGenerator(16, 3, fg, size, dtype=dtype, device=dev,
                       generator=torch.Generator(dev).manual_seed(seed))
    c_net = Critic(3, 8, size, dtype=dtype, device=dev,
                   generator=torch.Generator(dev).manual_seed(seed + 1))
    return (g_net, c_net, adam(g_net.parameters(), 2e-4, 0.5, 0.9),
            adam(c_net.parameters(), 2e-4, 0.5, 0.9))


@pytest.mark.parametrize("masked", [False, True])
def test_wgan_gradient_penalty_on_card_matches_cpu(dev, masked):
    """The penalty and its double backward into the critic's parameters
    (cuDNN's convolutions, BN, LeakyReLU on the card) against the CPU, f32,
    within 1e-4 * (1 + max|cpu|)."""
    from xgan_torch.models.wgan import Critic
    from xgan_torch.train.wgan import gradient_penalty
    g = torch.Generator().manual_seed(7)
    real = torch.randn(4, 64, 64, 3, generator=g)
    fake = torch.tanh(torch.randn(4, 64, 64, 3, generator=g))
    alpha = torch.rand(4, 1, 1, 1, generator=g)
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0]) if masked else None
    cpu = Critic(3, 8, 64, generator=torch.Generator().manual_seed(8))
    card = Critic(3, 8, 64, device=dev)
    card.load_state_dict(cpu.state_dict())
    out = []
    for c, d in ((cpu, "cpu"), (card, dev)):
        gp = gradient_penalty(c, real.to(d), fake.to(d), alpha.to(d), 10.0,
                              None if mask is None else mask.to(d))
        gp.backward()
        out.append([gp.detach().cpu()] + [p.grad.cpu()
                                          for p in c.parameters()])
    for want, got in zip(*out):
        tol = 1e-4 * (1 + want.abs().max().item())
        assert (got - want).abs().max().item() <= tol


def test_wgan_step_kernel_matches_plain(dev):
    """One f32 step (TF32 off, deterministic cuDNN, critic_iters 2) from the
    same weights and draws, with G's k4s2 forwards on the kernel and on
    the plain version: the losses within 1e-4 * (1 + |ref|), the norm of
    each of G's and the critic's gradients within 1e-3 relative."""
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    from xgan_torch.train.wgan import wgan_step
    g = torch.Generator(device=dev).manual_seed(2)
    store = torch.randint(0, 256, (12, 64, 64, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    idx = torch.arange(8, device=dev)
    draws = {"flip": torch.rand(8, generator=g, device=dev) < 0.5,
             "noises": [torch.randn(8, 16, generator=g, device=dev)
                        for _ in range(2)],
             "alphas": [torch.rand(8, 1, 1, 1, generator=g, device=dev)
                        for _ in range(2)],
             "g_noise": torch.randn(8, 16, generator=g, device=dev)}
    out = []
    torch.backends.cudnn.deterministic = True  # no atomics in the sums
    try:
        for convt in (None, convt4x4s2_fused_ref):
            g_net, c_net, opt_g, opt_c = _wgan_models(dev, 16, 64,
                                                      torch.float32)
            kw = {} if convt is None else {"convt": convt}
            kernels.reset_launch_counts()
            losses = wgan_step(g_net, c_net, opt_g, opt_c, store, idx,
                               latent_dim=16, critic_iters=2, lambda_gp=10.0,
                               **draws, **kw)
            assert kernels.LAUNCHES["convt4x4s2_fused"] == (
                15 if convt is None else 0)
            out.append((losses, [p.grad.norm().item() for p in
                                 [*g_net.parameters(), *c_net.parameters()]]))
    finally:
        torch.backends.cudnn.deterministic = False
    (l_k, n_k), (l_p, n_p) = out
    assert ((l_k - l_p).abs() <= 1e-4 * (1 + l_p.abs())).all()
    for a, b in zip(n_k, n_p):
        assert abs(a - b) <= 1e-3 * b


def test_wgan_bf16_step_launches_the_tensor_core_convt(dev):
    """Every k4s2 layer of the bf16 train-mode WGAN-GP G (fg 64: each Cin a
    multiple of 32) runs on the tensor-core kernel, critic_iters + 1 times
    a step."""
    from xgan_torch.train.wgan import wgan_step
    g_net, c_net, opt_g, opt_c = _wgan_models(dev, 64, 64, torch.bfloat16)
    store = torch.randint(0, 256, (8, 64, 64, 3), device=dev,
                          dtype=torch.uint8)
    gen = torch.Generator(dev).manual_seed(4)
    kernels.reset_launch_counts()
    for _ in range(2):
        losses = wgan_step(g_net, c_net, opt_g, opt_c, store,
                           torch.arange(8, device=dev), latent_dim=16,
                           critic_iters=3, lambda_gp=10.0,
                           dtype=torch.bfloat16, generator=gen)
    assert losses.shape == (4,) and torch.isfinite(losses).all()
    assert kernels.LAUNCHES["convt4x4s2_fused"] == 40
    assert kernels.LAUNCHES["convt4x4s2_mma"] == 40


# ---- CGAN (f32 with TF32 off by the ``dev`` fixture; no kernel on it) ----

def _cgan_nets(device, seed=0):
    from xgan_torch.models.cgan import Discriminator, Generator
    from xgan_torch.models.vgg import VGG16Features
    from xgan_torch.train.common import adam
    gen = torch.Generator().manual_seed(seed)
    g = Generator(16, 2, 3, 8, 64, generator=gen).to(device)
    d = Discriminator(2, 3, 8, 64, generator=gen).to(device)
    vgg = VGG16Features(generator=gen).to(device)
    return [g, d, vgg, adam(g.parameters(), 2e-4, 0.5),
            adam(d.parameters(), 2e-4, 0.5)]


def test_cgan_vgg_and_models_on_card_match_cpu(dev):
    """VGG16's three blocks, the perceptual loss and its input gradient,
    G's train forward and D's logits and 14 features on the card against
    the CPU, f32, within 1e-4 * (1 + max|cpu|)."""
    from xgan_torch.models.vgg import perceptual_loss
    gen = torch.Generator().manual_seed(3)
    x = torch.tanh(torch.randn(4, 64, 64, 3, generator=gen))
    y = torch.randn(4, 64, 64, 3, generator=gen)
    z = torch.randn(4, 16, generator=gen)
    labels = torch.tensor([0, 1, 1, 0])
    out = []
    for device in ("cpu", dev):
        g, d, vgg = _cgan_nets(device)[:3]
        xa = x.detach().to(device).requires_grad_()
        loss = perceptual_loss(vgg, xa, y.to(device))
        loss.backward()
        logits, feats = d(x.to(device), labels.to(device), train=True,
                          features=True)
        out.append([t.detach().float().cpu() for t in
                    [*vgg(x.to(device)), loss, xa.grad,
                     g.forward_train(z.to(device), labels.to(device)),
                     logits, *feats]])
    for i, (want, got) in enumerate(zip(*out)):
        tol = 1e-4 * (1 + want.abs().max().item())
        assert (got - want).abs().max().item() <= tol, i


def test_cgan_step_on_card_matches_cpu(dev):
    """One f32 CGAN step (deterministic cuDNN, 64 px, widths 8, B = 8)
    after 3 warm-up steps on the CPU, from the same weights, Adam states
    and draws: the 7 metrics within 1e-4 * (1 + |cpu|); the gradient norm
    of every tensor but the biases right before a BN (a zero gradient in
    exact arithmetic) within 1e-3 relative plus twice its floor, the
    largest move of that norm when the CPU step runs against itself with
    its conv outputs given 1e-6 rms noise (two draws): the gradient is
    discontinuous at the ReLU and max-pool decisions that rounding can
    flip (chip_smoke.py's CGAN step check)."""
    import copy
    from chip_smoke import noisy_convs, pre_bn_biases
    from xgan_torch.train.cgan import cgan_step
    gen = torch.Generator().manual_seed(5)
    store = torch.randint(0, 256, (16, 64, 64, 3), generator=gen,
                          dtype=torch.uint8)
    labels_all = torch.arange(16) % 2
    nets = _cgan_nets("cpu", seed=6)
    for t in range(3):
        cgan_step(*nets, store, labels_all, torch.arange(8) + t, 0,
                  latent_dim=16, generator=gen)
    warm = copy.deepcopy([m.state_dict() for m in nets[:2] + nets[3:]])
    draws = {"flip": torch.rand(8, generator=gen) < 0.5,
             "noise": torch.randn(8, 16, generator=gen),
             "fake_labels": torch.randint(0, 2, (8,), generator=gen),
             "real_targets": 0.9 - 0.1 * torch.rand(8, generator=gen),
             "fake_targets": 0.1 + 0.1 * torch.rand(8, generator=gen)}
    noisy = pre_bn_biases()

    def run(device, floor_seed=None):
        g, d, vgg, opt_g, opt_d = _cgan_nets(device, seed=6)
        for m, sd in zip((g, d, opt_g, opt_d), copy.deepcopy(warm)):
            m.load_state_dict(sd)
        with (noisy_convs(1e-6, floor_seed) if floor_seed is not None
              else contextlib.nullcontext()):
            m = cgan_step(g, d, vgg, opt_g, opt_d, store.to(device),
                          labels_all.to(device),
                          torch.arange(4, 12, device=device), 0,
                          latent_dim=16,
                          **{k: v.to(device) for k, v in draws.items()})
        return m.cpu(), {f"{p}.{k}": t.grad.norm().item()
                         for p, net in (("G", g), ("D", d))
                         for k, t in net.named_parameters()
                         if f"{p}.{k}" not in noisy}

    torch.backends.cudnn.deterministic = True
    try:
        (m_cpu, n_cpu), (m_card, n_card) = run("cpu"), run(dev)
    finally:
        torch.backends.cudnn.deterministic = False
    floors = [run("cpu", floor_seed=s)[1] for s in (1, 2)]
    assert ((m_card - m_cpu).abs() <= 1e-4 * (1 + m_cpu.abs())).all()
    for k, v in n_cpu.items():
        floor = max(abs(f[k] - v) / v for f in floors)
        assert abs(n_card[k] - v) <= (1e-3 + 2 * floor) * v, (k, floor)


# ---- the GAN loop features: K steps per call, grad-accum, snapshots ------

def _dcgan_run(dev, dtype, fg=8, size=32):
    """Seeded G and D (fd 8), their Adam optimizers (capturable, as the
    DCGAN trainer builds them on the card), an EMA and the step-draw
    generator, on the card."""
    from xgan_torch.models.dcgan import Discriminator
    from xgan_torch.train.common import adam
    from xgan_torch.train.ema import init_ema
    g_net = Generator(16, 3, fg, size, dtype=dtype, device=dev,
                      generator=torch.Generator(dev).manual_seed(0))
    d_net = Discriminator(3, 8, size, dtype=dtype, device=dev,
                          generator=torch.Generator(dev).manual_seed(1))
    opts = (adam(g_net.parameters(), 2e-4, 0.5, capturable=True),
            adam(d_net.parameters(), 2e-4, 0.5, capturable=True))
    return (g_net, d_net, *opts, init_ema(g_net),
            torch.Generator(dev).manual_seed(2))


def test_gan_steps_per_call_graph_matches_eager(dev):
    """Six f32 32-px steps with the EMA, as six eager steps and as three
    K = 2 calls (eager warm-up, capture and replay, replay), from the same
    weights and draws: metrics, weights and EMA within rtol 2e-4, atol
    2e-5 (tests/test_multistep.py:17); the dispatcher counts 2 replays of
    10 ConvT launches and the launch count comes out as six steps'."""
    from xgan_torch.train.ema import ema_update
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.multistep import StepsPerCall
    store = torch.randint(0, 256, (24, 32, 32, 3), device=dev,
                          dtype=torch.uint8,
                          generator=torch.Generator(dev).manual_seed(3))
    idx = torch.randperm(24, device=dev,
                         generator=torch.Generator(dev).manual_seed(4)) \
        .repeat(2).reshape(6, 8)
    runs = []
    for k in (1, 2):
        g_net, d_net, opt_g, opt_d, ema, draws = _dcgan_run(
            dev, torch.float32)

        def step(i):
            m = dcgan_step(g_net, d_net, opt_g, opt_d, store, i,
                           latent_dim=16, generator=draws)
            ema_update(ema, g_net, 0.9)
            return m

        kernels.reset_launch_counts()
        if k == 1:
            metrics = torch.stack([step(idx[t]) for t in range(6)])
        else:
            multi = StepsPerCall(step, 2, draws)
            metrics = torch.cat([multi(idx[t:t + 2]) for t in (0, 2, 4)])
            assert multi.replays == 2
            assert multi.launches_per_replay["convt4x4s2_fused"] == 10
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["convt4x4s2_fused"] == 30
        runs.append((metrics, g_net.state_dict(), d_net.state_dict(), ema))
    (m1, g1, d1, e1), (m2, g2, d2, e2) = runs
    torch.testing.assert_close(m2, m1, rtol=2e-4, atol=2e-5)
    for a, b in ((g1, g2), (d1, d2), (e1, e2)):
        for key in a:
            torch.testing.assert_close(b[key], a[key], rtol=2e-4,
                                       atol=2e-5, msg=key)


def test_gan_accum_step_kernel_matches_plain(dev):
    """One f32 A = 2 step (TF32 off, deterministic cuDNN) with G's k4s2
    forwards on the kernel and on the plain version: metrics within
    1e-4, G's gradient norms within 1e-3 relative; 2 * A * 5 launches."""
    from xgan_torch.kernels.convt import convt4x4s2_fused_ref
    from xgan_torch.train.gan import dcgan_step
    g = torch.Generator(device=dev).manual_seed(5)
    store = torch.randint(0, 256, (12, 64, 64, 3), generator=g, device=dev,
                          dtype=torch.uint8)
    idx = torch.arange(8, device=dev)
    flip = torch.rand(8, generator=g, device=dev) < 0.5
    noise = torch.randn(8, 16, generator=g, device=dev)
    out = []
    torch.backends.cudnn.deterministic = True
    try:
        for convt in (None, convt4x4s2_fused_ref):
            g_net, d_net, opt_g, opt_d = _gan_models(dev, 16, 64,
                                                     torch.float32)
            kw = {} if convt is None else {"convt": convt}
            kernels.reset_launch_counts()
            m = dcgan_step(g_net, d_net, opt_g, opt_d, store, idx,
                           latent_dim=16, flip=flip, noise=noise,
                           grad_accum=2, **kw)
            assert kernels.LAUNCHES["convt4x4s2_fused"] == (
                20 if convt is None else 0)
            out.append((m, [p.grad.norm().item()
                            for p in g_net.parameters()]))
    finally:
        torch.backends.cudnn.deterministic = False
    (m_k, n_k), (m_p, n_p) = out
    assert (m_k - m_p).abs().max().item() <= 1e-4
    for a, b in zip(n_k, n_p):
        assert abs(a - b) <= 1e-3 * b


def test_snapshot_round_trip_of_cuda_tensors(dev, tmp_path):
    """An async snapshot of a run on the card (capturable Adam state on
    the device, the CUDA step-draw generator) holds the state of the
    ``save`` call although the weights change right after it, and resumes
    into a fresh run: equal tensors, the same next draws."""
    from xgan_torch.train.gan import dcgan_step
    from xgan_torch.train.snapshot import (SnapshotManager, load_run_state,
                                           run_state)
    g_net, d_net, opt_g, opt_d, ema, draws = _dcgan_run(
        dev, torch.float32)
    store = torch.randint(0, 256, (8, 32, 32, 3), device=dev,
                          dtype=torch.uint8)
    dcgan_step(g_net, d_net, opt_g, opt_d, store, torch.arange(8, device=dev),
               latent_dim=16, generator=draws)
    models, opts = {"g": g_net, "d": d_net}, {"g": opt_g, "d": opt_d}
    want = {k: v.detach().cpu().clone()
            for k, v in g_net.state_dict().items()}
    mgr = SnapshotManager(str(tmp_path / "snapshot_last.pth"),
                          async_io=True)
    mgr.save(run_state(models, opts, ema, draws), 1, 1)
    want_draws = torch.randn(4, generator=draws, device=dev).cpu()
    with torch.no_grad():
        for p in g_net.parameters():
            p.add_(1.0)
    mgr.flush()
    fresh = _dcgan_run(dev, torch.float32)
    f_models = {"g": fresh[0], "d": fresh[1]}
    f_opts = {"g": fresh[2], "d": fresh[3]}
    snap, epoch, iters = mgr.try_resume(
        "auto", run_state(f_models, f_opts, fresh[4], fresh[5]))
    assert (epoch, iters) == (1, 1)
    load_run_state(snap, f_models, f_opts, fresh[4], fresh[5])
    for k, v in fresh[0].state_dict().items():
        torch.testing.assert_close(v.cpu(), want[k], rtol=0, atol=0)
    for st in fresh[2].state.values():
        assert st["step"].is_cuda and st["exp_avg"].is_cuda
    torch.testing.assert_close(
        torch.randn(4, generator=fresh[5], device=dev).cpu(), want_draws,
        rtol=0, atol=0)


def _rsna_tree(root, n_train=24, n_test=2, size=48):
    """A tiny RSNA-layout tree (PNGs by the port's own encoder, the two
    metadata CSVs), for the card tests, which run without the conftest's
    fixtures."""
    from xgan_torch.native.png import encode_png_batch
    rng = np.random.default_rng(0)
    for sub, n, prefix in (("Training/Images", n_train, "train"),
                           ("Test", n_test, "test")):
        (root / sub).mkdir(parents=True)
        assert encode_png_batch(
            rng.integers(0, 255, (n, size, size, 3), dtype=np.uint8),
            [str(root / sub / f"{prefix}{i:03d}.png")
             for i in range(n)]) == 0
    classes = ["Lung Opacity", "Normal", "No Lung Opacity / Not Normal"]
    (root / "stage2_train_metadata.csv").write_text(
        "patientId,class\n" + "".join(f"train{i:03d},{classes[i % 3]}\n"
                                      for i in range(n_train)))
    (root / "stage2_test_metadata.csv").write_text(
        "patientId,PredictionString\n" + "".join(
            f"test{i:03d},0.5 0 0 10 10\n" for i in range(n_test)))
    return str(root)


def test_gan_cli_steps_per_call_resume_is_bitwise(dev, tmp_path):
    """The DCGAN CLI on the card at K = 2 with the EMA, f32, B = 5 over
    24 train images: two chunks of 2 replayed as one graph and a
    masked tail run as one eager step an epoch. Straight through 2 epochs
    against 1 epoch then ``--resume-from auto`` (a new process state: the
    first chunk eager, a new capture): the histories equal and the final
    G, D and EMA state dicts bitwise equal, so the snapshot carried the
    capturable Adam state and the step-draw generator's offset after the
    replays."""
    from xgan_torch.cli import train_gan
    data_dir = _rsna_tree(tmp_path / "rsna")

    def run(name, n, *extra):
        out = tmp_path / name
        return train_gan.main([
            "--data-dir", data_dir,
            "--model-dir", str(out / "models"),
            "--output-dir", str(out / "results"),
            "--results-dir", str(out / "metrics"),
            "--figures-dir", str(out / "figures"),
            "--cache-dir", str(tmp_path / "cache"), "--image-size", "32",
            "--feature-maps-g", "8", "--feature-maps-d", "8",
            "--latent-dim", "16", "--vis-batch-size", "8",
            "--compute-dtype", "f32", "--batch-size", "5",
            "--steps-per-call", "2", "--ema-decay", "0.9",
            "--checkpoint-interval", "1", "--epochs", str(n), *extra])

    torch.backends.cudnn.deterministic = True
    try:
        straight = run("straight", 2)
        run("resumed", 1)
        resumed = run("resumed", 2, "--resume-from", "auto")
    finally:
        torch.backends.cudnn.deterministic = False
    assert len(straight["G_losses_iter"]) == 10
    assert resumed == straight
    for name in ("generator_final.pth", "discriminator_final.pth",
                 "generator_ema_final.pth"):
        a = torch.load(tmp_path / "straight/models/gan" / name,
                       weights_only=True)
        b = torch.load(tmp_path / "resumed/models/gan" / name,
                       weights_only=True)
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), f"{name} {k}"


# ---- WGAN-GP and CGAN steps per call, the CGAN gate, remat ---------------

@pytest.mark.parametrize("family", ["wgan", "cgan"])
def test_gan_family_cli_k2_matches_k1(dev, tmp_path, family):
    """The WGAN-GP (2 critic updates) and CGAN CLIs on the card, f32,
    B = 5 over 24 train images, 1 epoch: K = 2 (two chunks replayed as
    one graph each after the eager first, the masked tail as one step)
    against K = 1, both with the trainer's capturable Adam: history and
    final G and D within rtol 2e-4, atol 2e-5 (tests/test_multistep.py:17);
    WGAN-GP's graph holds the penalty's double backward and the ConvT
    kernel."""
    from xgan_torch.cli import train_cgan, train_wggan
    cli = train_wggan if family == "wgan" else train_cgan
    data_dir = _rsna_tree(tmp_path / "rsna")

    def run(name, *extra):
        out = tmp_path / name
        kernels.reset_launch_counts()
        history = cli.main([
            "--data-dir", data_dir, "--model-dir", str(out / "models"),
            "--output-dir", str(out / "results"),
            "--results-dir", str(out / "metrics"),
            "--figures-dir", str(out / "figures"),
            "--cache-dir", str(tmp_path / "cache"), "--image-size", "32",
            "--feature-maps-g", "8", "--feature-maps-d", "8",
            "--latent-dim", "16", "--vis-batch-size", "8",
            "--compute-dtype", "f32", "--batch-size", "5", "--epochs", "1",
            *(["--critic-iters", "2"] if family == "wgan" else []), *extra])
        torch.cuda.synchronize()
        return history, dict(kernels.LAUNCHES)

    torch.backends.cudnn.deterministic = True
    try:
        (h1, l1), (h2, l2) = run("k1"), run("k2", "--steps-per-call", "2")
    finally:
        torch.backends.cudnn.deterministic = False
    # 5 steps, (2 + 1) G forwards a step, 5 layers each, and the sheets
    assert l2 == l1 and (l1.get("convt4x4s2_fused", 0) > 0) == (
        family == "wgan")
    for key in h1:
        np.testing.assert_allclose(h2[key], h1[key], rtol=2e-4, atol=2e-5,
                                   err_msg=key)
    for name in ("generator_final.pth", "discriminator_final.pth"):
        a = torch.load(tmp_path / "k1/models" / family / name,
                       weights_only=True)
        b = torch.load(tmp_path / "k2/models" / family / name,
                       weights_only=True)
        for k in a:
            torch.testing.assert_close(b[k], a[k], rtol=2e-4, atol=2e-5,
                                       msg=f"{name} {k}")


def test_cgan_closed_gate_replay_leaves_d_untouched(dev):
    """A K = 2 CGAN dispatcher (capturable Adam) captured at epoch 0 and
    replayed at epoch 5 with the gate held closed (D's last BN pinned to
    a map of ones, label embeddings of +-c, reals labelled 0 and fakes
    1: D(x) ~ 1, D(G(z)) ~ 0): D's parameters and Adam state bitwise as
    before the replay, its BN buffers moved; G trained."""
    from xgan_torch.models.cgan import SEQ_D_BN
    from xgan_torch.train.cgan import cgan_step
    from xgan_torch.train.common import adam
    from xgan_torch.train.multistep import StepsPerCall
    g_net, d_net, vgg = _cgan_nets(dev, seed=7)[:3]
    opt_g = adam(g_net.parameters(), 2e-4, 0.5, capturable=True)
    opt_d = adam(d_net.parameters(), 2e-4, 0.5, capturable=True)
    emb, bn = d_net.label_emb.weight, d_net.main[SEQ_D_BN[-1]]
    c = 500.0 / emb.shape[1]
    with torch.no_grad():
        emb[0], emb[1] = c, -c
        bn.weight.zero_()
        bn.bias.fill_(1.0)
    gen = torch.Generator(dev).manual_seed(8)
    store = torch.randint(0, 256, (24, 64, 64, 3), device=dev,
                          dtype=torch.uint8, generator=gen)
    labels = torch.zeros(24, dtype=torch.int64, device=dev)
    fake_labels = torch.ones(8, dtype=torch.int64, device=dev)

    def step(i, epoch):
        return cgan_step(g_net, d_net, vgg, opt_g, opt_d, store, labels, i,
                         epoch, latent_dim=16, generator=gen,
                         fake_labels=fake_labels)

    multi = StepsPerCall(step, 2, gen)
    epoch = torch.tensor(0, device=dev)
    idx = torch.arange(16, device=dev).reshape(2, 8)
    multi(idx, epoch)
    multi(idx, epoch)  # the capture, then its first replay
    epoch.fill_(5)

    def snapshot(*objs):
        return [t.detach().clone() for o in objs
                for t in ([*o.parameters()] if isinstance(o, torch.nn.Module)
                          else [v for st in o.state.values()
                                for v in st.values() if torch.is_tensor(v)])]
    d_before, g_before = snapshot(d_net, opt_d), snapshot(g_net)
    bn_before = [b.clone() for b in d_net.buffers()]
    m = multi(idx, epoch)
    torch.cuda.synchronize()
    assert multi.replays == 2
    assert (m[:, 2] > 0.8).all() and (m[:, 3] < 0.2).all(), m
    assert all(torch.equal(a, b) for a, b in zip(snapshot(d_net, opt_d),
                                                 d_before))
    assert any(not torch.equal(a, b) for a, b in zip(d_net.buffers(),
                                                     bn_before))
    assert any(not torch.equal(a, b) for a, b in zip(snapshot(g_net),
                                                     g_before))


def test_remat_lowers_peak_memory(dev):
    """ResNet-50 (3,4,6,3) at 224 px, B = 16, f32, every parameter
    trained: a step's peak memory with stage and nested remat below the
    one without, and the logits of the three equal."""
    from xgan_torch.models.resnet import ResNet50
    x = torch.randn(16, 224, 224, 3, device=dev,
                    generator=torch.Generator(dev).manual_seed(9))
    peaks, logits = {}, {}
    for scope in (None, "stage", "nested"):
        model = ResNet50(2, device=dev, remat=scope is not None,
                         remat_scope=scope or "block",
                         generator=torch.Generator(dev).manual_seed(10))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        out = model(x, train=True)
        out.square().sum().backward()
        torch.cuda.synchronize()
        peaks[scope] = torch.cuda.max_memory_allocated() - held
        logits[scope] = out.detach()
        del model, out
        torch.cuda.empty_cache()
    assert peaks["stage"] < peaks[None] and peaks["nested"] < peaks[None], \
        peaks
    for scope in ("stage", "nested"):
        torch.testing.assert_close(logits[scope], logits[None], rtol=1e-5,
                                   atol=1e-5)


def test_maybe_trace_holds_every_kernel_of_its_window(dev, tmp_path):
    """``maybe_trace`` after a few other profiler windows in the same
    process, its first launches 3 ``mixed_gather`` kernels: the trace
    holds each of them, and every launch after the window's lead has its
    kernel in the trace."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from xgan_torch.utils.timer import maybe_trace
    real, synth, ridx, sidx, mask = _gather_inputs(dev, 64, 16, 32, 224)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            mixed_gather(real, synth, ridx, sidx, mask)
            torch.cuda.synchronize()
    err = new_error_flag(dev)
    with maybe_trace(str(tmp_path)):
        for _ in range(3):
            mixed_gather(real, synth, ridx, sidx, mask, err=err)
    raise_if_flagged(err)
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    events = json.loads(traces[0].read_text())["traceEvents"]
    ours = [e for e in events if e.get("cat") == "kernel"
            and "mixed_gather" in e.get("name", "")]
    assert len(ours) == 3, [e.get("name") for e in events
                            if e.get("cat") == "kernel"]
    lead = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == "trace_lead"]
    assert len(lead) == 1, lead
    lead_end = lead[0]["ts"] + lead[0]["dur"]
    kernels_seen = {e["args"].get("correlation") for e in events
                    if e.get("cat") == "kernel"}
    lost = [e["name"] for e in events if e.get("cat") == "cuda_runtime"
            and "LaunchKernel" in e.get("name", "") and e["ts"] > lead_end
            and e["args"].get("correlation") not in kernels_seen]
    assert not lost, lost


@pytest.mark.parametrize("k,b,s", [(5, 32, 224), (3, 5, 33), (2, 1, 8)])
def test_fold_batched_gather_matches_plain(dev, k, b, s):
    """(k, B) indices (--parallel-folds): one launch, bitwise equal to the
    plain version and to k single launches; a bad index in one fold
    raises through the flag."""
    g = torch.Generator(device=dev).manual_seed(k)
    real, synth, _, _, _ = _gather_inputs(dev, 11, 4, 1, s)
    ridx = torch.randint(0, 11, (k, b), generator=g, device=dev)
    sidx = torch.randint(0, 4, (k, b), generator=g, device=dev)
    mask = torch.rand((k, b), generator=g, device=dev) < 0.5
    kernels.reset_launch_counts()
    got = mixed_gather(real, synth, ridx, sidx, mask)
    assert kernels.LAUNCHES["mixed_gather"] == 1
    assert got.shape == (k, b, s, s, 3)
    assert torch.equal(got, mixed_gather_ref(real, synth, ridx, sidx, mask))
    singles = torch.stack([mixed_gather(real, synth, ridx[f], sidx[f],
                                        mask[f]) for f in range(k)])
    assert torch.equal(got, singles)
    bad = ridx.clone()
    bad[k - 1, b - 1] = 11
    with pytest.raises(IndexError):
        mixed_gather(real, synth, bad, sidx, mask)
    with pytest.raises(RuntimeError):  # the op checks the shapes agree
        mixed_gather_cuda(real, synth, ridx, sidx.reshape(-1), mask)


def test_png_unfilter_op_matches_plain(dev):
    """The compiled host op against the plain version: every filter type,
    every bytes-per-pixel 1-8; an unknown filter type raises
    ValueError."""
    from xgan_torch.kernels.build import load_ops
    from xgan_torch.native.png import _unfilter
    op = load_ops().png_unfilter
    rng = np.random.default_rng(0)
    for bpp in range(1, 9):
        for stride in (1, bpp, 7 * bpp + 1):
            raw = rng.integers(0, 256, (10, 1 + stride), dtype=np.uint8)
            raw[:, 0] = np.arange(10) % 5
            np.testing.assert_array_equal(
                op(torch.from_numpy(raw), 10, stride, bpp).numpy(),
                _unfilter(raw, 10, stride, bpp))
    raw[2, 0] = 6
    with pytest.raises(ValueError, match="row filter 6"):
        op(torch.from_numpy(raw), 10, stride, 8)


@pytest.mark.parametrize("ctype,depth,interlace", [
    (0, 8, False), (0, 16, False), (0, 1, True), (2, 16, True),
    (3, 4, False), (4, 8, True), (6, 16, False)])
def test_store_decode_with_the_compiled_unfilter(dev, tmp_path, monkeypatch,
                                                 ctype, depth, interlace):
    """The store's decode through the compiled op equals the plain
    path's, for both 16-bit rules; a compiled store build calls no plain
    unfilter."""
    from chip_smoke import PNG_CHANNELS, png_bytes
    from xgan_torch.data.store import ImageStore
    from xgan_torch.native import png
    from xgan_torch.native.png import decode_png
    rng = np.random.default_rng(ctype + depth)
    hi = min(1 << depth, 9) if ctype == 3 else 1 << depth
    samples = rng.integers(0, hi, (37, 37, PNG_CHANNELS[ctype]))
    path = str(tmp_path / "x.png")
    with open(path, "wb") as f:
        f.write(png_bytes(samples, ctype, depth, interlace=interlace,
                          filters=(0, 1, 2, 3, 4),
                          palette=rng.integers(0, 256, (9, 3))
                          if ctype == 3 else None))
    for rule in ("high", "clip"):
        got = decode_png(path, grey16=rule, compiled=True)
        assert np.array_equal(got, decode_png(path, grey16=rule))
        assert got.std() > 0
    routes, inner = [], png.unfilter

    def counted(*args, compiled=False, **kw):
        routes.append(compiled)
        return inner(*args, compiled=compiled, **kw)
    monkeypatch.setattr(png, "unfilter", counted)
    ImageStore.build([path], np.zeros(1, np.int32), 37, compiled=True)
    assert routes and all(routes)


def test_lockstep_step_on_card_matches_cpu(dev):
    """One f32 lockstep step (k = 3, stages (1,1,1,1), 32 px, B = 8, a
    padded tail; TF32 off) on the card against the CPU from the same
    weights and draws: one fold-batched gather launch; losses, fc and BN
    statistics within 1e-4."""
    from xgan_torch.data.pipeline import DeviceStore
    from xgan_torch.data.store import ImageStore
    from xgan_torch.models.resnet import ResNet50
    from xgan_torch.train.parallel_folds import (FoldAdam, FoldStack,
                                                 lockstep_train_step)
    rng = np.random.default_rng(2)
    k, b = 3, 8
    real = ImageStore(rng.integers(0, 255, (12, 32, 32, 3), np.uint8),
                      np.arange(12) % 2, 32)
    synth = ImageStore(rng.integers(0, 255, (5, 32, 32, 3), np.uint8),
                       np.ones(5), 32)
    t = torch.from_numpy
    draws = {"idx": t(rng.integers(0, 12, (k, b))),
             "use_synth": t(rng.random((k, b)) < 0.5),
             "synth_pick": t(rng.integers(0, 5, (k, b))),
             "flip": t(rng.random((k, b)) < 0.5)}
    mask = torch.ones(k, b)
    mask[2, 6:] = 0
    inits = [ResNet50(2, stage_sizes=(1, 1, 1, 1),
                      generator=torch.Generator().manual_seed(f)).state_dict()
             for f in range(k)]
    out = {}
    for d in ("cpu", dev):
        models = []
        for sd in inits:
            m = ResNet50(2, stage_sizes=(1, 1, 1, 1), device=d)
            m.load_state_dict(sd)
            models.append(m)
        stack = FoldStack(models, [n for n, _ in models[0]
                                   .named_parameters()])
        opt = FoldAdam(stack.trainable, k, 1e-3)
        kernels.reset_launch_counts()
        losses, _, _ = lockstep_train_step(
            stack, opt, DeviceStore(real, d), DeviceStore(synth, d),
            draws["idx"].to(d), mask.to(d), mode="mix", ratio=0.5,
            **{n: v.to(d) for n, v in draws.items() if n != "idx"})
        assert kernels.LAUNCHES["mixed_gather"] == (d != "cpu")
        out[str(d)] = (losses.cpu(), [stack.state_dict(f) for f in range(k)])
    (l_cpu, s_cpu), (l_dev, s_dev) = out.values()
    valid = mask > 0
    assert ((l_cpu - l_dev).abs()[valid]).max() <= 1e-4 * (
        1 + l_cpu.abs().max())
    for a, c in zip(s_cpu, s_dev):
        for n, v in a.items():
            if n.startswith("fc.") or "running" in n:
                assert (v - c[n]).abs().max() <= 1e-4, n


# ---- serving artifacts on the card ------------------------------------------

def _g_artifact(dev, tmp_path, dtype, quantize="none"):
    """A bf16 G-64 (fg 64) exported on the card; (artifact, live model)."""
    from xgan_torch.io_ import export
    g = Generator(16, 3, 64, 64, dtype=dtype, device=dev,
                  generator=torch.Generator(dev).manual_seed(0)).eval()
    ep = export.export_program(
        export.build_program("gan", g, quantize=quantize),
        export.example_inputs("gan", image_size=64, latent_dim=16,
                              device=dev))
    path = str(tmp_path / "g.pt2")
    export.save_exported(path, ep, {"kind": "gan"})
    return export.load_exported(path, dev), g


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_artifact_runs_the_kernel_and_equals_the_live_model(
        dev, tmp_path, dtype):
    """An artifact exported on the card calls the ConvT ops (in bf16 the
    wgmma and band ones the route picks), which torch.profiler sees 5 times a call
    while the Python counts see none; its images equal the live model's
    bitwise."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from xgan_torch.data.pipeline import tanh_to_u8
    art, g = _g_artifact(dev, tmp_path, dtype)
    ops = (["xgan_torch.convt4x4s2_band.default",
            "xgan_torch.convt4x4s2_wgmma.default"]
           if dtype == torch.bfloat16
           else ["xgan_torch.convt4x4s2_fused.default"])
    assert art.kernel_ops == ops
    z = torch.randn(8, 16, device=dev)
    want = tanh_to_u8(g(z))
    kernels.reset_launch_counts()
    got = art.call(z)
    torch.cuda.synchronize()
    assert not kernels.LAUNCHES  # inside the program: no Python wrapper
    assert torch.equal(got, want)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        art.call(z)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA and "convt4x4s2" in e.name]
    assert len(names) == 5, names


def test_card_int8_artifact_matches_its_live_program(dev, tmp_path):
    from xgan_torch.io_ import export
    art, g = _g_artifact(dev, tmp_path, torch.bfloat16, "int8")
    program = export.build_program("gan", g, quantize="int8")
    z = torch.randn(4, 16, device=dev)
    with torch.no_grad():
        want = program(z)
    assert (art.call(z).short() - want.short()).abs().max() <= 1


def test_cpu_artifact_is_refused_on_the_card(dev, tmp_path, capsys):
    """A program exported on the CPU holds the plain ConvT: the loader
    refuses it on the card, and the sampler exits 1 with its error."""
    from xgan_torch.cli import generate_synthetic
    from xgan_torch.io_ import export
    g = Generator(16, 3, 8, 64).eval()
    path = str(tmp_path / "cpu.pt2")
    export.save_exported(path, export.export_program(
        export.build_program("gan", g), export.example_inputs(
            "gan", image_size=64, latent_dim=16, device="cpu")))
    with pytest.raises(ValueError, match="exported on cpu"):
        export.load_exported(path, dev)
    with pytest.raises(SystemExit) as e:
        generate_synthetic.main(["--model-path", path, "--output-dir",
                                 str(tmp_path / "out"), "--num-images", "2"])
    assert e.value.code == 1
    assert "exported on cpu" in capsys.readouterr().out


def test_generate_is_bucket_invariant_on_the_card(dev, tmp_path):
    """The server runs every generator dispatch at --max-batch rows, so
    a request's image does not depend on how many shared its batch: each
    row of an 8-row dispatch equals the same latent's in a dispatch that
    pads one request to 8 rows."""
    from xgan_torch.cli import serve
    art, _ = _g_artifact(dev, tmp_path, torch.bfloat16)
    desc = {"kind": "generator", "generate_batch": art.call,
            "latent_dim": 16, "conditional": False, "num_classes": 2}
    batcher = serve.make_batcher(desc, dev, 8, None, 0)
    together = batcher.run_bucket([(serve.latent(s, 16), 0)
                                   for s in range(8)], 8)
    for s in range(8):
        alone = batcher.run_bucket([(serve.latent(s, 16), 0)], 8)[0]
        np.testing.assert_array_equal(alone, together[s])
