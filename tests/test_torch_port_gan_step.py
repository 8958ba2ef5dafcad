"""xgan_torch's ``dcgan_step`` against the JAX package's
``make_dcgan_step``, from the same weights (carried across by the port's
converters) with the JAX step's own flip and noise draws injected
(``jax.random.split(fold_in(k_data, t))``, as the JAX epoch loop makes
them).

The envelope of tests/test_torch_trajectory.py (f32, 32 px, widths 8,
B = 4, 30 steps): metrics within 1e-4 over the first 3 steps and 5e-2
over all 30 (reduction-order noise grows through the D/G feedback); BN
running statistics after step 3 within 1e-2 relative; parameters within
2 * lr * N (Adam moves a near-zero-gradient coordinate by up to lr a
step whichever sign the noise gives it). One masked tail step (16 rows,
8 valid, of a 24-image store) is held at 1e-4, and the trained
generator's repacked eval forward equals the flax eval forward of its
weights carried back through the JAX package's ``.pth`` codec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trajectory import (STATS_T, _assert_traj,
                                         _param_drift, _stats_drift)
from tests.torch_port_util import (bn_stats_from_torch,
                                   discriminator_vars_from_torch)
from xgan.models import dcgan as jax_dcgan
from xgan.models.pretrained import load_torch_gan_generator
from xgan.train.common import adam as jax_adam
from xgan.train.common import create_state
from xgan.train.gan import make_dcgan_step
from xgan_torch.models.convert import (discriminator_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.dcgan import SEQ_BN, SEQ_D_BN, Discriminator, \
    Generator
from xgan_torch.train.common import adam
from xgan_torch.train.gan import dcgan_step

torch.set_num_threads(1)

LATENT, FM, SIZE, B, LR = 8, 8, 32, 4, 2e-4


def _setup(seed=0):
    g_model = jax_dcgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                  image_size=SIZE)
    d_model = jax_dcgan.Discriminator(feature_maps=FM, image_size=SIZE)
    g_tx, d_tx = jax_adam(LR, 0.5), jax_adam(LR, 0.5)
    key = jax.random.key(seed)
    g_state = create_state(g_model, g_tx, key, jnp.zeros((2, LATENT)),
                           train=False)
    d_state = create_state(d_model, d_tx, key,
                           jnp.zeros((2, SIZE, SIZE, 3)), train=False)
    step = make_dcgan_step(g_model, d_model, g_tx, d_tx, latent_dim=LATENT,
                           donate=False)
    g = Generator(LATENT, 3, FM, SIZE)
    g.load_state_dict(generator_state_dict_from_jax(
        *jax.device_get((g_state.params, g_state.batch_stats))))
    d = Discriminator(3, FM, SIZE)
    d.load_state_dict(discriminator_state_dict_from_jax(
        *jax.device_get((d_state.params, d_state.batch_stats))))
    return (g_model, g_state, d_state, step), (g, d, adam(
        g.parameters(), LR, 0.5), adam(d.parameters(), LR, 0.5))


def _draws(key, b):
    """The flip mask and noise the JAX step draws from ``key``."""
    k_flip, k_noise = jax.random.split(key)
    flip = np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))
    noise = np.array(jax.random.normal(k_noise, (b, LATENT)))
    return torch.from_numpy(flip), torch.from_numpy(noise)


def _store(n, seed):
    return np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3),
                                                np.uint8)


def test_trajectory_matches_make_dcgan_step(tmp_path):
    n = 30
    (g_model, g_state, d_state, step), (g, d, opt_g, opt_d) = _setup()
    images = _store(16, seed=3)
    idx = np.stack([(np.arange(B) + B * t) % 16 for t in range(n)])
    k_data = jax.random.key(5)
    store = torch.from_numpy(images)

    ours, theirs = [], []
    for t in range(n):
        key = jax.random.fold_in(k_data, t)
        g_state, d_state, m = step(g_state, d_state, jnp.asarray(images),
                                   jnp.asarray(idx[t]), key)
        theirs.append(np.asarray(m))
        flip, noise = _draws(key, B)
        ours.append(dcgan_step(
            g, d, opt_g, opt_d, store, torch.from_numpy(idx[t]).long(),
            latent_dim=LATENT, flip=flip, noise=noise).numpy())
        if t == STATS_T - 1:
            jax_stats = jax.device_get((g_state.batch_stats,
                                        d_state.batch_stats))
            port_stats = ([(s["mean"], s["var"]) for s in
                           bn_stats_from_torch(g, SEQ_BN).values()],
                          [(s["mean"], s["var"]) for s in
                           bn_stats_from_torch(d, SEQ_D_BN).values()])
    _assert_traj("port dcgan metrics", np.stack(ours), np.stack(theirs),
                 atol=5e-2, early_atol=1e-4)
    assert _stats_drift(jax_stats[0], port_stats[0]) < 1e-2
    assert _stats_drift(jax_stats[1], port_stats[1]) < 1e-2
    bound = 2 * LR * n
    assert _param_drift(g_state.params, g.main, transpose_conv=True) < bound
    assert _param_drift(d_state.params, d.main, transpose_conv=False) < bound

    # the trained G: repacked eval forward == flax eval forward of its
    # weights carried back through the JAX package's .pth codec
    path = str(tmp_path / "generator.pth")
    torch.save(g.state_dict(), path)
    params, stats = load_torch_gan_generator(path)
    z = np.random.default_rng(7).normal(size=(3, LATENT)).astype(np.float32)
    want = np.asarray(g_model.apply({"params": params, "batch_stats": stats},
                                    jnp.asarray(z), train=False))
    zt = torch.from_numpy(z)
    stale = g(zt).numpy()  # the weights packed before training
    g.repack()
    got = g(zt).numpy()
    tol = 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    assert np.abs(stale - want).max() > 10 * tol


@pytest.mark.parametrize("valid", [8, 0])
def test_masked_tail_step_matches_jax(valid):
    """A wrap-padded tail batch of 16 rows over a 24-image store, the
    last 16 - valid rows masked out of every BN statistic, loss and
    metric mean (``valid`` 0: a mask of zeros)."""
    (_, g_state, d_state, step), (g, d, opt_g, opt_d) = _setup(seed=1)
    images = _store(24, seed=4)
    idx = np.resize(np.random.default_rng(5).permutation(24), 40)[24:]
    mask = (np.arange(16) < valid).astype(np.float32)
    key = jax.random.key(6)
    g_state, d_state, want = step(g_state, d_state, jnp.asarray(images),
                                  jnp.asarray(idx), key,
                                  mask=jnp.asarray(mask))
    flip, noise = _draws(key, 16)
    got = dcgan_step(g, d, opt_g, opt_d, torch.from_numpy(images),
                     torch.from_numpy(idx).long(), latent_dim=LATENT,
                     mask=torch.from_numpy(mask), flip=flip, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    params, stats = discriminator_vars_from_torch(d)
    want_p, want_s = jax.device_get((d_state.params, d_state.batch_stats))
    for name in want_p:
        for k, v in want_p[name].items():
            np.testing.assert_allclose(params[name][k], v, rtol=0,
                                       atol=1e-5, err_msg=f"{name}.{k}")
    for name in want_s:
        for k, v in want_s[name].items():
            np.testing.assert_allclose(stats[name][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}.{k}")
    assert _param_drift(g_state.params, g.main, transpose_conv=True) < 1e-5


def test_step_takes_its_draws_from_the_generator():
    """Without injected draws the flip and noise come from ``generator``:
    the same seed gives the same step."""
    images = torch.from_numpy(_store(8, seed=8))
    idx = torch.arange(B)
    out = []
    for _ in range(2):
        g = Generator(LATENT, 3, FM, SIZE,
                      generator=torch.Generator().manual_seed(0))
        d = Discriminator(3, FM, SIZE,
                          generator=torch.Generator().manual_seed(1))
        m = dcgan_step(g, d, adam(g.parameters(), LR, 0.5),
                       adam(d.parameters(), LR, 0.5), images, idx,
                       latent_dim=LATENT,
                       generator=torch.Generator().manual_seed(2))
        assert m.shape == (5,) and torch.isfinite(m).all()
        out.append(m)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
