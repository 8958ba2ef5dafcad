"""xgan_torch's CGAN generator, projection discriminator and VGG16 features
against the JAX package's (``xgan.models.cgan``, ``xgan.models.vgg``), with
the weights carried across by the port's converters, random BN running
statistics and f32 throughout, at 32 px and width 8.

- Generator eval forward and ``forward_train`` (with and without a tail
  mask), discriminator logits and all 14 feature-matching activations
  (reference aliasing included) in train and eval mode, masked and not:
  within 1e-5. Running statistics after a train forward: rtol 1e-5, atol
  1e-6.
- A CGAN generator ``.pth`` written by the JAX package's codec
  (``save_torch_cgan_generator``) loads strictly and gives the flax
  images; the reference ``nn.Sequential`` discriminator's state dict loads
  strictly and gives its logits.
- ``VGG16Features`` block outputs, ``perceptual_loss``,
  ``feature_matching_loss`` and ``layerwise_mse`` with and without
  weights: within 1e-5 relative.
- The vgg16 validator refuses a vgg19-shaped dict, missing keys and wrong
  shapes with the JAX package's messages; a torchvision-layout vgg16 state
  dict (classifier included) loads.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_generator_pth import _RefCGANGenerator
from tests.test_torch_trajectory import _RefCGANDiscriminator
from tests.torch_port_util import bn_stats_from_torch, jax_cgan
from xgan.models import pretrained as jax_pretrained
from xgan.models import vgg as jax_vgg
from xgan.ops import reduce as jax_reduce
from xgan.train.cgan import feature_matching_loss as jax_fm
from xgan_torch.models import cgan
from xgan_torch.models.cgan import SEQ_D_BN, SEQ_G_BN, Discriminator, \
    Generator
from xgan_torch.models.convert import (cgan_discriminator_state_dict_from_jax,
                                       cgan_generator_state_dict_from_jax,
                                       chw_to_hwc_perm,
                                       vgg_state_dict_from_jax)
from xgan_torch.models.vgg import (VGG16Features, load_vgg16_pth,
                                   perceptual_loss, validate_vgg16_state_dict)
from xgan_torch.ops.reduce import layerwise_mse, per_sample_mse
from xgan_torch.train.cgan import feature_matching_loss

torch.set_num_threads(1)

LATENT, NF, SIZE, B = 16, 8, 32, 4
MASKS = {"none": None, "tail": [1, 1, 1, 0]}
TOL = 1e-5


def _close(got, want, what, rel=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    tol = TOL * (1 + np.abs(want).max()) if rel else TOL
    assert err <= tol, f"{what}: max |got - want| {err:.3g} > {tol:.3g}"


def _stats_close(ours, theirs):
    for name, s in theirs.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(ours[name][k], np.asarray(s[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{k}")


def _mask(kind):
    m = MASKS[kind]
    return None if m is None else np.asarray(m, np.float32)


def _labels(seed):
    return np.random.default_rng(seed).integers(0, 2, B).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    return jax_cgan(LATENT, NF, SIZE, seed=3)


def _port_g(g_vars):
    g = Generator(LATENT, 2, 3, NF, SIZE)
    g.load_state_dict(cgan_generator_state_dict_from_jax(*g_vars),
                      strict=True)
    return g


def _port_d(d_vars):
    d = Discriminator(2, 3, NF, SIZE)
    d.load_state_dict(cgan_discriminator_state_dict_from_jax(*d_vars),
                      strict=True)
    return d


@pytest.mark.parametrize("train,mask", [(True, "none"), (True, "tail"),
                                        (False, "none")])
def test_generator_matches_flax(models, train, mask):
    g_model, _, g_vars, _ = models
    z = np.random.default_rng(1).normal(size=(B, LATENT)).astype(np.float32)
    y = _labels(2)
    m = _mask(mask)
    kw = {} if m is None else {"mask": jnp.asarray(m)}
    variables = {"params": g_vars[0], "batch_stats": g_vars[1]}
    # eager: the port's order of arithmetic for the masked BN statistics
    if train:
        want, upd = g_model.apply(variables, jnp.asarray(z), jnp.asarray(y),
                                  train=True, mutable=["batch_stats"], **kw)
        want_stats = upd["batch_stats"]
    else:
        want = g_model.apply(variables, jnp.asarray(z), jnp.asarray(y),
                             train=False)
        want_stats = g_vars[1]
    assert np.asarray(want).std() > 0.1

    g = _port_g(g_vars)
    zt, yt = torch.from_numpy(z), torch.from_numpy(y)
    if train:
        got = g.forward_train(zt, yt, None if m is None
                              else torch.from_numpy(m))
        assert got.requires_grad
        got = got.detach()
    else:
        got = g(zt, yt)
    assert got.shape == (B, SIZE, SIZE, 3) and got.dtype == torch.float32
    assert got.is_contiguous()
    rows = slice(None) if m is None else m > 0  # masked rows: garbage
    _close(got.numpy()[rows], np.asarray(want)[rows], "images")
    _stats_close(bn_stats_from_torch(g, SEQ_G_BN), want_stats)


def test_jax_written_generator_pth_loads_strictly(models, tmp_path):
    """``save_torch_cgan_generator`` (the JAX package's ``.pth`` writer)
    -> the port's generator, strictly, and the same eval images; the
    reference module loads the port's state dict strictly too."""
    g_model, _, (params, stats), _ = models
    path = str(tmp_path / "generator_final.pth")
    jax_pretrained.save_torch_cgan_generator(path, params, stats)
    g = Generator(LATENT, 2, 3, NF, SIZE)
    g.load_state_dict(torch.load(path, weights_only=True), strict=True)
    z = np.random.default_rng(5).normal(size=(B, LATENT)).astype(np.float32)
    y = _labels(6)
    want = g_model.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(z), jnp.asarray(y), train=False)
    _close(g(torch.from_numpy(z), torch.from_numpy(y)).numpy(), want,
           "images")
    ref = _RefCGANGenerator(LATENT, 2, 3, NF, SIZE // 32)
    ref.load_state_dict(g.state_dict(), strict=True)
    assert list(ref.state_dict()) == list(g.state_dict())


@pytest.mark.parametrize("train,mask", [(True, "none"), (True, "tail"),
                                        (False, "none")])
def test_discriminator_matches_flax(models, train, mask):
    """Logits and the 14 aliased activations (flax NHWC, the port NCHW)."""
    _, d_model, _, d_vars = models
    x = np.random.default_rng(7).normal(
        size=(B, SIZE, SIZE, 3)).astype(np.float32)
    y = _labels(8)
    m = _mask(mask)
    kw = {} if m is None else {"mask": jnp.asarray(m)}
    variables = {"params": d_vars[0], "batch_stats": d_vars[1]}
    if train:
        (want, want_feats), upd = jax.jit(partial(
            d_model.apply, train=True, features=True,
            mutable=["batch_stats"]))(variables, jnp.asarray(x),
                                      jnp.asarray(y), **kw)
        want_stats = upd["batch_stats"]
    else:
        want, want_feats = d_model.apply(variables, jnp.asarray(x),
                                         jnp.asarray(y), train=False,
                                         features=True)
        want_stats = d_vars[1]

    d = _port_d(d_vars)
    got, feats = d(torch.from_numpy(x), torch.from_numpy(y), train=train,
                   features=True,
                   mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (B,) and got.dtype == torch.float32
    assert len(feats) == len(want_feats) == 14
    # the reference's aliasing: the first pair and each block's last two
    # entries are one tensor
    assert feats[0] is feats[1]
    assert all(feats[i] is feats[i + 1] for i in (3, 6, 9, 12))
    rows = slice(None) if m is None else m > 0
    _close(got.detach().numpy()[rows], np.asarray(want)[rows], "logits")
    for i, (f, w) in enumerate(zip(feats, want_feats)):
        _close(f.detach().permute(0, 2, 3, 1).numpy()[rows],
               np.asarray(w)[rows], f"feature {i}")
    _stats_close(bn_stats_from_torch(d, SEQ_D_BN), want_stats)
    # features=False: the same logits alone
    if not train:
        _close(d(torch.from_numpy(x), torch.from_numpy(y),
                 train=False).detach().numpy(), want, "logits alone")


def test_reference_discriminator_loads_strictly(models):
    """The reference ``nn.Sequential`` projection discriminator (weights
    copied from flax by the trajectory test's helper, which permutes the
    embedding itself) has the port's keys; its state dict loads strictly
    and gives the same logits (NCHW there, NHWC here)."""
    from tests.test_torch_trajectory import _copy_cgan_d
    _, _, _, (params, stats) = models
    ref = _RefCGANDiscriminator(NF, SIZE // 32)
    _copy_cgan_d(params, ref, NF, SIZE // 32)
    d = Discriminator(2, 3, NF, SIZE)
    d.load_state_dict(ref.state_dict(), strict=True)
    assert list(ref.state_dict()) == list(d.state_dict())
    x = torch.randn(B, SIZE, SIZE, 3, generator=torch.Generator()
                    .manual_seed(9))
    y = torch.from_numpy(_labels(10).astype(np.int64))
    want = ref.train()(x.permute(0, 3, 1, 2), y)
    _close(d(x, y, train=True).detach().numpy(), want.detach().numpy(),
           "logits")
    # the converter puts the embedding where _copy_cgan_d does
    sd = cgan_discriminator_state_dict_from_jax(params, stats)
    torch.testing.assert_close(sd["label_emb.weight"],
                               ref.label_emb.weight.detach(), rtol=0, atol=0)


def test_chw_perm_matches_the_jax_package():
    for c, s0 in ((8, 1), (16, 7), (3, 2)):
        np.testing.assert_array_equal(chw_to_hwc_perm(c, s0),
                                      jax_pretrained._chw_to_hwc_perm(c, s0))


@pytest.fixture(scope="module")
def vgg_pair():
    model = jax_vgg.VGG16Features()
    params = jax.device_get(model.init(jax.random.key(4),
                                       jnp.zeros((1, SIZE, SIZE, 3)))
                            ["params"])
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(params), strict=True)
    return model, params, vgg


def test_vgg_features_match_flax(vgg_pair):
    model, params, vgg = vgg_pair
    x = np.random.default_rng(11).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = jax.jit(model.apply)({"params": params}, jnp.asarray(x))
    got = vgg(torch.from_numpy(x))
    assert [tuple(f.shape) for f in got] == [(2, 64, 32, 32),
                                             (2, 128, 16, 16),
                                             (2, 256, 8, 8)]
    for i, (f, w) in enumerate(zip(got, want)):
        _close(f.permute(0, 2, 3, 1).numpy(), w, f"relu block {i + 1}",
               rel=True)
    assert not any(p.requires_grad for p in vgg.parameters())


@pytest.mark.parametrize("mask", ["none", "tail"])
def test_perceptual_loss_matches_xgan(vgg_pair, mask):
    """The loss and its gradient in x; y's side takes no gradient."""
    model, params, vgg = vgg_pair
    rng = np.random.default_rng(12)
    x = np.tanh(rng.normal(size=(B, SIZE, SIZE, 3))).astype(np.float32)
    y = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    m = _mask(mask)
    w = None if m is None else jnp.asarray(m)

    def jax_loss(xj):
        return jax_vgg.perceptual_loss(
            lambda p, v: model.apply({"params": p}, v), params, xj,
            jnp.asarray(y), weights=w, concat=False)

    want, want_grad = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    got = perceptual_loss(vgg, xt, yt,
                          None if m is None else torch.from_numpy(m))
    got.backward()
    _close(got.item(), float(want), "perceptual", rel=True)
    _close(xt.grad.numpy(), want_grad, "d perceptual / dx", rel=True)
    assert yt.grad is None


@pytest.mark.parametrize("mask", ["none", "tail"])
def test_feature_matching_and_layerwise_mse_match_xgan(mask):
    rng = np.random.default_rng(13)
    shapes = [(B, 4, 8, 8), (B, 8, 4, 4), (B, 16, 2, 2)]
    a = [rng.normal(size=s).astype(np.float32) for s in shapes]
    b = [rng.normal(size=s).astype(np.float32) for s in shapes]
    m = _mask(mask)
    w_t = None if m is None else torch.from_numpy(m)
    w_j = None if m is None else jnp.asarray(m)
    ta = [torch.from_numpy(v) for v in a]
    tb = [torch.from_numpy(v) for v in b]
    _close(per_sample_mse(ta[0], tb[0]).numpy(),
           jax_reduce.per_sample_mse(jnp.asarray(a[0]), jnp.asarray(b[0])),
           "per_sample_mse")
    want = jax_reduce.layerwise_mse([jnp.asarray(v) for v in a],
                                    [jnp.asarray(v) for v in b], w_j)
    _close(layerwise_mse(ta, tb, w_t).item(), float(want), "layerwise_mse")
    _close(feature_matching_loss(ta, tb, w_t).item(),
           float(jax_fm([jnp.asarray(v) for v in a],
                        [jnp.asarray(v) for v in b], w_j)), "fm")
    # identical features give exactly 0; a +1 shift gives 1 per layer
    assert feature_matching_loss(ta, ta, w_t).item() == 0.0
    assert feature_matching_loss(ta, [v + 1 for v in ta], w_t).item() \
        == pytest.approx(3.0)


def _vgg16_like_sd(deeper=False):
    """A torchvision-layout vgg16 (or, ``deeper``, vgg19) state dict:
    conv weights at the features indices, a classifier."""
    convs = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    if deeper:
        convs = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]
    widths = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512,
              512, 512, 512]
    sd, cin = {}, 3
    for idx, cout in zip(convs, widths):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(cout) * 0.05
        cin = cout
    sd["classifier.0.weight"] = torch.zeros(8, 4)
    return sd


def test_vgg_validator_refuses_like_the_jax_package(tmp_path):
    bad = {"vgg19": _vgg16_like_sd(deeper=True),
           "missing": {k: v for k, v in _vgg16_like_sd().items()
                       if not k.startswith("features.7.")},
           "shape": {**_vgg16_like_sd(),
                     "features.12.weight": torch.zeros(128, 256, 3, 3)}}
    for name, sd in bad.items():
        with pytest.raises(ValueError) as ours:
            validate_vgg16_state_dict(sd)
        with pytest.raises(ValueError) as theirs:
            jax_pretrained._validate_vgg16_sd(
                {k: v.numpy() for k, v in sd.items()})
        assert str(ours.value) == str(theirs.value), name
        assert {"vgg19": "features.16", "missing": "missing",
                "shape": "features.12.weight"}[name] in str(ours.value)
    validate_vgg16_state_dict(_vgg16_like_sd())


def test_vgg16_pth_loads(tmp_path):
    """A torchvision-layout vgg16 ``.pth`` loads its first three blocks
    (the classifier and deeper convs ignored); the JAX package's importer
    reads the same numbers."""
    sd = _vgg16_like_sd()
    path = str(tmp_path / "vgg16.pth")
    torch.save(sd, path)
    vgg = VGG16Features()
    load_vgg16_pth(vgg, path)
    torch.testing.assert_close(vgg.features[14].weight,
                               sd["features.14.weight"], rtol=0, atol=0)
    params = jax_pretrained.load_torch_vgg16(path)
    np.testing.assert_array_equal(
        vgg_state_dict_from_jax(params)["features.10.weight"].numpy(),
        sd["features.10.weight"].numpy())


def test_init_draws_the_reference_distributions():
    gen = torch.Generator().manual_seed(14)
    g = Generator(100, 2, 3, 32, 224, generator=gen)
    d = Discriminator(2, 3, 32, 224, generator=gen)
    assert g.fc.weight.shape == (32 * 8 * 49, 100)
    assert [g.main[s].weight.shape[0] for s in cgan.SEQ_G_CONV] == \
        [128, 64, 32, 16, 3]
    assert [d.main[s].weight.shape[0] for s in cgan.SEQ_D_CONV] == \
        [16, 32, 64, 128, 256, 1]
    assert d.label_emb.weight.shape == (2, 256 * 49)
    w = d.main[8].weight
    assert abs(w.mean().item()) < 1e-3 and abs(w.std().item() - 0.02) < 1e-3
    b = d.main[8].bias  # U(±1/sqrt(64 * 16))
    assert b.abs().max().item() <= 1 / 32 and b.std().item() > 0.01
    assert g.fc.weight.abs().max().item() <= 0.1
    assert abs(g.label_emb.weight.std().item() - 1) < 0.2
    bn = g.main[4]
    assert abs(bn.weight.mean().item() - 1) < 0.01 and not bn.bias.any()
    v = VGG16Features(generator=torch.Generator().manual_seed(15))
    w = v.features[10].weight  # std sqrt(2 / 1152) / 0.8796 before cutting
    std = (2 / 1152) ** 0.5 / 0.87962566103423978
    assert w.abs().max().item() <= 2 * std
    assert abs(w.std().item() - (2 / 1152) ** 0.5) < 2e-3
    assert not v.features[10].bias.any()
