"""xgan_torch's weight-only int8 quantization against the JAX package's.

The same weights in both layouts: every int8 tensor and every scale must
equal ``xgan.io_.quant.quantize_params``'s bitwise after the layout map
(flax HWIO / (in, out) with the output axis last; torch OIHW, (I, O, kh,
kw) for ConvTranspose2d with the spatial flip, (out, in)), and so must the
dequantized weights. BN parameters and statistics, biases and embeddings
stay full precision."""
import jax
import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_cgan, jax_generator
from xgan.io_ import quant as jax_quant
from xgan_torch.io_ import quant
from xgan_torch.io_.checkpoint import state_dict_from_flax
from xgan_torch.models import cgan, dcgan
from xgan_torch.models.convert import chw_to_hwc_perm, convt_hwio_to_torch
from xgan_torch.models.resnet import ResNet50
from xgan.models.resnet import ResNet50 as JaxResNet50

torch.set_num_threads(1)

LATENT, FG, SIZE = 16, 8, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _check_leaf(port_leaf, jax_leaf, to_torch, out_dim):
    """q8, the scales and the dequantized weight, bitwise, after the
    layout map ``to_torch``."""
    _eq(port_leaf["q8"], to_torch(np.asarray(jax_leaf["q8"])))
    assert port_leaf["q8"].dtype == torch.int8
    scale = port_leaf["q8_scale"]
    assert scale.dim() == port_leaf["q8"].dim()
    assert scale.shape[out_dim] == scale.numel()
    _eq(scale.flatten(), np.asarray(jax_leaf["q8_scale"]))
    deq = np.asarray(jax_quant.dequantize_params({"k": jax_leaf})["k"])
    _eq(quant.dequantize_params({"k": port_leaf})["k"], to_torch(deq))


def test_conv_transpose2d_matches_jax():
    _, params, stats = jax_generator(LATENT, FG, SIZE, seed=2)
    g = dcgan.Generator(LATENT, 3, FG, SIZE)
    g.load_state_dict(state_dict_from_flax(
        g, {"params": params, "batch_stats": stats}))
    got = quant.quantize_params(g)
    want = _np(jax_quant.quantize_params(params))
    for i, seq in enumerate(dcgan.SEQ_CONVT):
        _check_leaf(got[f"main.{seq}.weight"],
                    want[f"ConvTranspose_{i}"]["kernel"],
                    convt_hwio_to_torch, 1)
    for i, seq in enumerate(dcgan.SEQ_BN):  # BN untouched
        for name in ("weight", "bias"):
            assert torch.equal(got[f"main.{seq}.{name}"],
                               getattr(g.main[seq], name))


def test_conv2d_linear_and_embedding_match_jax():
    """The CGAN generator: 3x3 convs with biases, the fc (its columns in
    CHW order in torch, HWC in flax), the label embedding."""
    _, _, (params, stats), _ = jax_cgan(LATENT, FG, SIZE, seed=3)
    g = cgan.Generator(LATENT, feature_maps=FG, image_size=SIZE)
    g.load_state_dict(state_dict_from_flax(
        g, {"params": params, "batch_stats": stats}))
    got = quant.quantize_params(g)
    want = _np(jax_quant.quantize_params(params))
    for i, seq in enumerate(cgan.SEQ_G_CONV):
        _check_leaf(got[f"main.{seq}.weight"], want[f"Conv_{i}"]["kernel"],
                    lambda k: np.transpose(k, (3, 2, 0, 1)), 0)
        assert torch.equal(got[f"main.{seq}.bias"], g.main[seq].bias)
    inv = np.argsort(chw_to_hwc_perm(FG * 8, SIZE // 32))
    _check_leaf(got["fc.weight"], want["Dense_0"]["kernel"],
                lambda k: np.transpose(k[:, inv]), 0)
    assert torch.equal(got["fc.bias"], g.fc.bias)
    # embeddings stay full precision on both sides
    assert not isinstance(want["label_emb"], dict)
    assert torch.equal(got["label_emb.weight"], g.label_emb.weight)


def test_resnet_matches_jax_and_keeps_bn():
    model = JaxResNet50(num_classes=2, stage_sizes=(1, 1, 1, 1))
    v = _np(model.init(jax.random.key(0), np.zeros((1, 32, 32, 3)),
                       train=False))
    net = ResNet50(2, stage_sizes=(1, 1, 1, 1))
    net.load_state_dict(state_dict_from_flax(net, v))
    got = quant.quantize_params(net)
    want = _np(jax_quant.quantize_params(v["params"]))

    def oihw(k):
        return np.transpose(k, (3, 2, 0, 1))

    _check_leaf(got["conv1.weight"], want["stem"]["kernel"], oihw, 0)
    _check_leaf(got["layer2.0.downsample.0.weight"],
                want["layer2_0"]["downsample"]["kernel"], oihw, 0)
    _check_leaf(got["fc.weight"], want["fc"]["kernel"], np.transpose, 0)
    n_q = sum(quant._is_qleaf(x) for x in got.values())
    n_jax = sum(1 for p, _ in jax.tree_util.tree_flatten_with_path(
        want)[0] if jax.tree_util.keystr(p).endswith("['q8']"))
    assert n_q == n_jax == 4 * 3 + 4 + 2  # 3 convs a block, 4 downsamples
    for name, p in net.named_parameters():  # BN and biases untouched
        if "bn" in name or name.endswith("bias") or "downsample.1" in name:
            assert torch.equal(got[name], p), name


def test_dequantize_is_identity_on_unquantized():
    g = dcgan.Generator(LATENT, 3, FG, SIZE)
    plain = {n: p.detach() for n, p in g.named_parameters()}
    out = quant.dequantize_params(plain)
    assert out.keys() == plain.keys()
    assert all(out[k] is plain[k] for k in plain)
    assert not quant.is_quantized(plain)
    assert quant.is_quantized(quant.quantize_params(g))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 50.0])
def test_quantize_weight_bounds(scale):
    """|w - dequant(w)| <= s / 2 per output channel, the int8 range is
    [-127, 127], and an all-zero channel stays zero (the 1e-12 floor)."""
    w = torch.randn(6, 5, 3, 3, generator=torch.Generator().manual_seed(0))
    w = w * scale
    w[2] = 0
    leaf = quant.quantize_weight(w, 0)
    back = quant.dequantize_params({"w": leaf})["w"]
    assert leaf["q8"].abs().max() <= 127
    assert ((back - w).abs() <= leaf["q8_scale"] / 2 + 1e-12).all()
    assert (back[2] == 0).all()
