"""xgan_torch's WGAN-GP generator and critic against the JAX package's
flax modules (``xgan.models.wgan``), with the weights carried across by the
port's converters, random BN running statistics and f32 throughout.

- Generator eval forward and ``forward_train``, critic scores in train
  and eval mode, with and without a tail mask: within 1e-5 (the same f32
  arithmetic in other orders). Running statistics after a train forward:
  rtol 1e-5, atol 1e-6.
- 32 px at width 8; the critic also at 224 px and width 4, where its last
  map is 8x8 (2x2 at 32 px), so its spatial mean is exercised.
- The reference ``nn.Sequential`` critic's state dict loads strictly and
  gives the same scores; the widths argument leaves the DCGAN generator's
  state-dict keys and shapes as they were.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_generator_pth import _RefDCGANGenerator
from tests.test_torch_trajectory import _torch_wgan_models
from tests.torch_port_util import (bn_stats_from_torch, jax_discriminator,
                                   jax_generator)
from xgan.models import dcgan as jax_dcgan
from xgan.models import wgan as jax_wgan
from xgan.models.pretrained import load_torch_gan_generator
from xgan_torch.models import dcgan, wgan
from xgan_torch.models.convert import (critic_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.dcgan import SEQ_BN
from xgan_torch.models.wgan import SEQ_C_BN, Critic, Generator

torch.set_num_threads(1)

LATENT, B = 16, 4
CASES = [(32, 8), (224, 4)]
MASKS = {"none": None, "tail": [1, 1, 1, 0]}
TOL = 1e-5


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= TOL, f"{what}: max |got - want| {err:.3g} > {TOL}"


def _stats_close(ours, theirs):
    for name, s in theirs.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(ours[name][k], np.asarray(s[k]),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name}.{k}")


def _mask(kind):
    m = MASKS[kind]
    return None if m is None else np.asarray(m, np.float32)


def _jax_apply(model, params, stats, x, train, mask, jit=True):
    """The flax forward, jitted (one compile instead of one per op) or
    eager (one XLA op at a time, the port's order of arithmetic)."""
    kw = {} if mask is None else {"mask": jnp.asarray(mask)}
    variables = {"params": params, "batch_stats": stats}
    if train:
        fn = partial(model.apply, train=True, mutable=["batch_stats"])
    else:
        fn = partial(model.apply, train=False)
    out = (jax.jit(fn) if jit else fn)(variables, jnp.asarray(x), **kw)
    return (out[0], out[1]["batch_stats"]) if train else (out, stats)


@pytest.mark.parametrize("train,mask", [(True, "none"), (True, "tail"),
                                        (False, "none")])
def test_generator_matches_flax(train, mask):
    size, fg = CASES[0]
    model, params, stats = jax_generator(LATENT, fg, size, seed=size + fg,
                                         family=jax_wgan)
    z = np.random.default_rng(size).normal(
        size=(B, LATENT)).astype(np.float32)
    m = _mask(mask)
    # eager: under jit XLA reorders the tail's masked BN statistics, which
    # at 32 px the first layer takes from 3 rows of 1x1 maps (4e-5 apart)
    want, want_stats = _jax_apply(model, params, stats, z, train, m,
                                  jit=False)
    assert np.asarray(want).std() > 0.1

    g = Generator(LATENT, 3, fg, size)
    g.load_state_dict(generator_state_dict_from_jax(params, stats),
                      strict=True)
    zt = torch.from_numpy(z)
    if train:
        got = g.forward_train(zt, None if m is None else torch.from_numpy(m))
        assert got.requires_grad
        got = got.detach()
    else:
        got = g(zt)
    assert got.shape == (B, size, size, 3) and got.dtype == torch.float32
    # rows a mask leaves out are garbage by contract
    rows = slice(None) if m is None else m > 0
    _close(got.numpy()[rows], np.asarray(want)[rows], "images")
    _stats_close(bn_stats_from_torch(g, SEQ_BN), want_stats)


@pytest.mark.parametrize("train,mask", [(True, "none"), (True, "tail"),
                                        (False, "none")])
@pytest.mark.parametrize("size,fd", CASES)
def test_critic_matches_flax(size, fd, train, mask):
    model, params, stats = jax_discriminator(fd, size, seed=size + fd,
                                             family=jax_wgan)
    x = np.random.default_rng(size + 1).normal(
        size=(B, size, size, 3)).astype(np.float32)
    m = _mask(mask)
    want, want_stats = _jax_apply(model, params, stats, x, train, m)

    c = Critic(3, fd, size)
    c.load_state_dict(critic_state_dict_from_jax(params, stats), strict=True)
    got = c(torch.from_numpy(x), train=train,
            mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got.detach().numpy(), want, "scores")
    _stats_close(bn_stats_from_torch(c, SEQ_C_BN), want_stats)


@pytest.mark.parametrize("train", [True, False])
def test_reference_critic_loads_strictly(train):
    """The reference ``nn.Sequential`` critic's state dict (conv at
    main.{0,2,5,8,11}, BN at main.{3,6,9}) loads into the port's strictly,
    and both give the same scores (the reference NCHW, the port NHWC)."""
    torch.manual_seed(0)
    _, ref = _torch_wgan_models(8)  # FM 8, 32 px
    with torch.no_grad():
        for mod in ref.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    c = Critic(3, 8, 32)
    result = c.load_state_dict(ref.state_dict(), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert list(ref.state_dict()) == list(c.state_dict())
    x = torch.randn(B, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    ref.train(train)
    want = ref(x.permute(0, 3, 1, 2))
    got = c(x, train=train)
    _close(got.detach().numpy(), want.detach().numpy(), "scores")
    for a, b in zip(ref.state_dict().values(), c.state_dict().values()):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_reference_generator_loads_strictly():
    """The reference WGAN-GP generator (the DCGAN ``nn.Sequential`` one
    width up) loads strictly; the eval images match its eval forward."""
    torch.manual_seed(2)
    ref, _ = _torch_wgan_models(8)
    g = Generator(8, 3, 8, 32)  # the replica's latent is 8
    g.load_state_dict(ref.state_dict(), strict=True)
    z = torch.randn(B, 8, generator=torch.Generator().manual_seed(3))
    want = ref.eval()(z.reshape(B, 8, 1, 1)).permute(0, 2, 3, 1)
    _close(g(z).numpy(), want.detach().numpy(), "images")


def test_widths_leave_the_dcgan_generator_as_it_was():
    """The default ladder is the DCGAN one: the keys and shapes of the
    reference DCGAN generator, its eval forward unchanged by naming the
    widths; the WGAN-GP generator has the same keys one width up."""
    fg, size = 8, 64
    ref = _RefDCGANGenerator(LATENT, [fg * 8, fg * 4, fg * 2, fg, fg // 2],
                             3, size // 32)
    g = dcgan.Generator(LATENT, 3, fg, size,
                        generator=torch.Generator().manual_seed(4))
    shapes = {k: tuple(v.shape) for k, v in g.state_dict().items()}
    assert shapes == {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    named = dcgan.Generator(LATENT, 3, fg, size,
                            widths=[fg * 8, fg * 4, fg * 2, fg, fg // 2])
    named.load_state_dict(g.state_dict(), strict=True)
    z = torch.randn(3, LATENT, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(named(z), g(z), rtol=0, atol=0)
    torch.testing.assert_close(named.forward_train(z), g.forward_train(z),
                               rtol=0, atol=0)

    w = wgan.Generator(LATENT, 3, fg, size)
    assert list(w.state_dict()) == list(g.state_dict())
    assert [w.main[s].weight.shape[1] for s in dcgan.SEQ_CONVT] == \
        [fg * 16, fg * 8, fg * 4, fg * 2, fg, 3]
    with pytest.raises(ValueError, match="5 layers"):
        dcgan.Generator(LATENT, 3, fg, size, widths=[8, 8, 8])


def test_generator_converter_covers_both_families():
    """One converter carries both flax generators: the same
    ConvTranspose_0..5 and TorchBatchNorm_0..4 names, other widths."""
    for family, cls in ((jax_dcgan, dcgan.Generator),
                        (jax_wgan, wgan.Generator)):
        _, params, stats = jax_generator(LATENT, 8, 32, family=family)
        assert sorted(params) == sorted(
            [f"ConvTranspose_{i}" for i in range(6)]
            + [f"TorchBatchNorm_{i}" for i in range(5)])
        sd = generator_state_dict_from_jax(params, stats)
        cls(LATENT, 3, 8, 32).load_state_dict(sd, strict=True)
    with pytest.raises(RuntimeError, match="size mismatch"):
        dcgan.Generator(LATENT, 3, 8, 32).load_state_dict(sd, strict=True)


def test_generator_pth_loads_in_the_jax_package(tmp_path):
    """The port's WGAN-GP state dict, saved as .pth, loads through the JAX
    package's codec (``GENERATOR_TORCH_CODECS["wgan"]``) and gives the
    same eval images in flax."""
    g = Generator(LATENT, 3, 8, 32, generator=torch.Generator().manual_seed(6))
    z = torch.randn(2, LATENT, generator=torch.Generator().manual_seed(7))
    g.forward_train(z)  # running statistics away from 0 / 1
    g.repack()
    path = str(tmp_path / "generator_final.pth")
    torch.save(g.state_dict(), path)
    params, stats = load_torch_gan_generator(path)
    model = jax_wgan.Generator(latent_dim=LATENT, feature_maps=8,
                               image_size=32)
    want = model.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(z.numpy()), train=False)
    _close(g(z).numpy(), want, "eval images")


def test_critic_init_draws_the_reference_distributions():
    c = Critic(3, 64, 224, generator=torch.Generator().manual_seed(8))
    assert [c.main[s].weight.shape[0] for s in wgan.SEQ_C_CONV] == \
        [64, 128, 256, 512, 1]
    assert c.main[11].weight.shape[-1] == 224 // 32
    w = c.main[8].weight
    assert abs(w.mean().item()) < 1e-3 and abs(w.std().item() - 0.02) < 1e-3
    bn = c.main[9]
    assert abs(bn.weight.mean().item() - 1) < 0.01 and not bn.bias.any()
    assert wgan.Discriminator is Critic
