"""``bench_port/flops.py`` against ``torch.utils.flop_counter`` on the
reference's own forwards, at a small size."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import catalog, flops
from bench_port.reference.common import Numerics, leaf_params

SMALL = {"image_size": 64, "feature_maps_g": 16, "feature_maps_d": 16}


def _params(ref, cfg):
    gen = torch.Generator().manual_seed(0)
    out = {}
    for net, items in ref.leaves(cfg).items():
        out[net] = leaf_params({n: torch.randn(shape, generator=gen) * 0.02
                                for n, shape, _ in items})
    return out


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("name", ["dcgan224", "wgan224"])
def test_forward_flops_match_the_counter(name):
    cfg = dict(catalog.config(name), **SMALL)
    ref = catalog.reference(cfg)
    p = _params(ref, cfg)
    b, num = 3, Numerics()
    z = torch.randn(b, cfg["latent_dim"])
    x = torch.randn(b, cfg["num_channels"], 64, 64)
    g = _count(lambda: ref.generator_forward(p["g"], z, num))
    disc = ref.critic if cfg["family"] == "wgan" else ref.discriminator
    d = _count(lambda: disc(p["d"], x, num))
    assert flops.g_forward(cfg, b) == g
    assert flops.d_forward(cfg, b) == d


@pytest.mark.parametrize("name", ["dcgan224", "wgan224"])
def test_convt_layers_and_bound(name):
    cfg = catalog.config(name)
    layers = flops.convt_layers(cfg)
    assert [h for h, _, _ in layers] == [7, 14, 28, 56, 112]
    assert layers[-1][2] == 3
    peaks = {"flops": 989e12, "bytes_per_s": 3.35e12}
    b = catalog.cell({"dcgan224": "dcgan224-b128-k4",
                      "wgan224": "wgan224-b64-n5"}[name])["batch"]
    bound = flops.convt_bound_s(cfg, b, peaks)
    # each layer is bound by its FLOPs or by its bytes, whichever is slower
    per_layer = [max(flops.convt_flops(b, h, ci, co) / 989e12,
                     2 * (b * h * h * ci + 16 * ci * co
                          + b * 4 * h * h * co) / 3.35e12)
                 for h, ci, co in layers]
    assert bound == pytest.approx(sum(per_layer))


def test_step_coefficients():
    for name, cell in (("dcgan224", "dcgan224-b128-k4"),
                       ("wgan224", "wgan224-b64-n5")):
        cfg, b = catalog.config(name), catalog.cell(cell)["batch"]
        a, c = cfg["step_flops"]["g_forwards"], cfg["step_flops"]["d_forwards"]
        assert flops.step(cfg, b) == a * flops.g_forward(cfg, b) \
            + c * flops.d_forward(cfg, b)
    w = catalog.config("wgan224")
    n = w["critic_iters"]
    assert (w["step_flops"]["g_forwards"], w["step_flops"]["d_forwards"]) \
        == (n + 3, 12 * n + 2)
    assert w["g_train_forwards_per_step"] == n + 1
