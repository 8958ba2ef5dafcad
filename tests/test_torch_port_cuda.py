"""xgan_torch's CUDA kernels on the card: each against its plain version
at small and odd shapes, and the op's argument checks. Marked ``cuda``;
they skip on a host without a CUDA device. Run on the card with

    python -m pytest tests/test_torch_port_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

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
