"""xgan_torch's DCGAN Discriminator and train-mode Generator against the
JAX package's flax modules, with the weights carried across by the
port's converters and random BN running statistics.

- Logits and generator outputs (f32): within 1e-4; the same f32
  arithmetic in other orders (measured: at most 1.5e-5). An all-zero mask
  normalizes by 1/sqrt(eps) at each BN (outputs garbage by contract, up
  to ~1e10 in D): there 1e-4 of max|ref|.
- Running statistics after the train forward: rtol 1e-5 with atol 1e-6
  (a mean over B*H*W f32 values and a 0.9/0.1 blend).
- Sizes 32 and 64 at width 8, and 224 px at width 4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_parity import build_torch_models
from tests.torch_port_util import (bn_stats_from_torch, jax_discriminator,
                                   jax_generator)
from xgan.models.pretrained import load_torch_gan_generator
from xgan_torch.models.convert import (discriminator_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.dcgan import (SEQ_BN, SEQ_CONVT, SEQ_D_BN,
                                     Discriminator, Generator)

torch.set_num_threads(1)

LATENT, B = 16, 4
CASES = [(32, 8), (64, 8), (224, 4)]
MASKS = {"none": None, "tail": [1, 1, 1, 0], "zeros": [0, 0, 0, 0]}


def _close(got, want, what, relative=False):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    tol = 1e-4 * (np.abs(want).max() if relative else 1.0)
    err = np.abs(got - want).max()
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


def _jax_apply(model, params, stats, x, train, mask):
    kw = {} if mask is None else {"mask": jnp.asarray(mask)}
    if not train:
        return model.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=False), stats
    out, upd = model.apply({"params": params, "batch_stats": stats},
                           jnp.asarray(x), train=True,
                           mutable=["batch_stats"], **kw)
    return out, upd["batch_stats"]


@pytest.mark.parametrize("train,mask", [(True, "none"), (True, "tail"),
                                        (True, "zeros"), (False, "none")])
@pytest.mark.parametrize("size,fd", CASES)
def test_discriminator_matches_flax(size, fd, train, mask):
    model, params, stats = jax_discriminator(fd, size, seed=size + fd)
    x = np.random.default_rng(size).normal(
        size=(B, size, size, 3)).astype(np.float32)
    m = _mask(mask)
    want, want_stats = _jax_apply(model, params, stats, x, train, m)

    d = Discriminator(3, fd, size)
    d.load_state_dict(discriminator_state_dict_from_jax(params, stats),
                      strict=True)
    got = d(torch.from_numpy(x), train=train,
            mask=None if m is None else torch.from_numpy(m))
    assert got.shape == (B,) and got.dtype == torch.float32
    _close(got.detach().numpy(), want, "logits", relative=mask == "zeros")
    _stats_close(bn_stats_from_torch(d, SEQ_D_BN), want_stats)


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("size,fg", CASES)
def test_generator_train_forward_matches_flax(size, fg, mask):
    model, params, stats = jax_generator(LATENT, fg, size, seed=size + fg)
    z = np.random.default_rng(size + 1).normal(
        size=(B, LATENT)).astype(np.float32)
    m = _mask(mask)
    want, want_stats = _jax_apply(model, params, stats, z, True, m)

    g = Generator(LATENT, 3, fg, size)
    g.load_state_dict(generator_state_dict_from_jax(params, stats),
                      strict=True)
    got = g.forward_train(torch.from_numpy(z),
                          None if m is None else torch.from_numpy(m))
    assert got.shape == (B, size, size, 3) and got.requires_grad
    _close(got.detach().numpy(), want, "images", relative=mask == "zeros")
    _stats_close(bn_stats_from_torch(g, SEQ_BN), want_stats)


def test_repack_follows_trained_weights():
    """The eval forward reads the ConvT weights as packed at repack (the
    first one too, whose packed form at 32 px could be a view): after
    they change it is stale until ``repack()``."""
    g = Generator(LATENT, 3, 8, 32, generator=torch.Generator()
                  .manual_seed(0))
    z = torch.randn(3, LATENT, generator=torch.Generator().manual_seed(1))
    before = g(z)
    with torch.no_grad():
        for seq in SEQ_CONVT:
            g.main[seq].weight.mul_(1.5)
    assert torch.equal(g(z), before)
    g.repack()
    fresh = Generator(LATENT, 3, 8, 32)
    fresh.load_state_dict(g.state_dict())
    torch.testing.assert_close(g(z), fresh(z), rtol=0, atol=0)
    assert not torch.equal(g(z), before)


def test_generator_pth_loads_in_the_jax_package(tmp_path):
    """The port's state dict, saved as .pth, loads through the JAX
    package's codec and gives the same eval images."""
    g = Generator(LATENT, 3, 8, 64,
                  generator=torch.Generator().manual_seed(2))
    z = torch.randn(2, LATENT, generator=torch.Generator().manual_seed(3))
    g.forward_train(z)  # running statistics away from 0 / 1
    g.repack()
    path = str(tmp_path / "generator_final.pth")
    torch.save(g.state_dict(), path)
    params, stats = load_torch_gan_generator(path)
    model, _, _ = jax_generator(LATENT, 8, 64)
    want = model.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(z.numpy()), train=False)
    _close(g(z).numpy(), want, "eval images")


@pytest.mark.parametrize("train", [True, False])
def test_reference_discriminator_loads_strictly(train):
    """The reference nn.Sequential discriminator's state dict loads into
    the port's strictly, and both give the same logits (the reference
    NCHW, the port NHWC)."""
    _, ref = build_torch_models()  # FM 8, 32 px
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(0.5, 1.5)
    d = Discriminator(3, 8, 32)
    ref_sd = {f"main.{k}": v for k, v in ref.state_dict().items()}
    result = d.load_state_dict(ref_sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    x = torch.randn(B, 32, 32, 3, generator=torch.Generator().manual_seed(4))
    ref.train(train)
    want = ref(x.permute(0, 3, 1, 2)).reshape(B)
    got = d(x, train=train)
    _close(got.detach().numpy(), want.detach().numpy(), "logits")
    for a, b in zip(ref.state_dict().values(), d.state_dict().values()):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_init_draws_the_reference_distributions():
    gen = torch.Generator().manual_seed(5)
    d = Discriminator(3, 64, 224, generator=gen)
    w = d.main[8].weight
    assert abs(w.mean().item()) < 1e-3 and abs(w.std().item() - 0.02) < 1e-3
    bn = d.main[9]
    assert abs(bn.weight.mean().item() - 1) < 0.01 and not bn.bias.any()
    g1 = Generator(LATENT, 3, 8, 32, generator=torch.Generator()
                   .manual_seed(6))
    g2 = Generator(LATENT, 3, 8, 32, generator=torch.Generator()
                   .manual_seed(6))
    for a, b in zip(g1.parameters(), g2.parameters()):
        assert torch.equal(a, b)
