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
                                      convt4x4s2_fused_ref,
                                      pack_convt_weight)
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
    b, h, cin, cout = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, h, cin, generator=g, device=dev).to(dtype)
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
