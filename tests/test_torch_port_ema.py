"""xgan_torch's generator EMA (``--ema-decay``, ``xgan_torch/train/
ema.py``) against the JAX package's ``xgan.train.ema``.

``ema_update`` equals ``xgan.train.ema.ema_update`` on the same numpy
weights (atol 1e-7); training with the EMA on is bitwise the same as with
it off; three DCGAN steps with the EMA follow ``make_dcgan_step(
ema_decay=...)`` within the trajectory envelope of
tests/test_torch_trajectory.py (metrics within 1e-4, weights and EMA
within 2 * lr * N); the trainer's ``generator_ema_final.pth`` has the EMA
parameters and the raw generator's BN buffers and loads into the sampler;
``--ema-decay`` outside [0, 1) is refused at parse time, as by the JAX
CLI."""
import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_gan_step import (B, LATENT, LR, _draws, _setup,
                                            _store)
from tests.test_torch_trajectory import _assert_traj, _param_drift
from tests.torch_port_util import jax_generator
from xgan import config as jax_config
from xgan.models import dcgan as jax_dcgan
from xgan.train.common import adam as jax_adam
from xgan.train.ema import ema_update as jax_ema_update
from xgan.train.gan import make_dcgan_step
from xgan_torch import config
from xgan_torch.cli import generate_synthetic
from xgan_torch.cli import train_gan as cli
from xgan_torch.models.convert import ema_from_jax, \
    generator_state_dict_from_jax
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.ema import ema_update, init_ema
from xgan_torch.train.gan import dcgan_step

torch.set_num_threads(1)

DECAY = 0.5


@pytest.mark.parametrize("decay", [0.5, 0.999])
def test_ema_update_matches_jax(decay):
    _, params, stats = jax_generator(LATENT, 8, 32, seed=0)
    rng = np.random.default_rng(1)
    ema_tree = jax.tree_util.tree_map(
        lambda p: (p + 0.1 * rng.normal(size=p.shape)).astype(np.float32),
        params)
    want = jax.device_get(jax_ema_update(ema_tree, params, decay))

    g = Generator(LATENT, 3, 8, 32)
    g.load_state_dict(generator_state_dict_from_jax(params, stats))
    ema = ema_from_jax(ema_tree, stats)
    assert set(ema) == {k for k, _ in g.named_parameters()}
    ema_update(ema, g, decay)
    expect = ema_from_jax(want, stats)
    for k, v in ema.items():
        torch.testing.assert_close(v, expect[k], rtol=0, atol=1e-7)


def _steps(n, ema_decay, seed=0):
    """``n`` DCGAN steps on the CPU from seeded weights and draws: the
    trained G and D and the EMA (None when off)."""
    g = Generator(LATENT, 3, 8, 32, generator=torch.Generator().manual_seed(
        seed))
    d = Discriminator(3, 8, 32,
                      generator=torch.Generator().manual_seed(seed + 1))
    opt_g, opt_d = adam(g.parameters(), LR, 0.5), adam(d.parameters(), LR,
                                                        0.5)
    ema = init_ema(g) if ema_decay else None
    draws = torch.Generator().manual_seed(seed + 2)
    store = torch.from_numpy(_store(16, seed=3))
    for t in range(n):
        dcgan_step(g, d, opt_g, opt_d, store, (torch.arange(B) + B * t) % 16,
                   latent_dim=LATENT, generator=draws)
        if ema is not None:
            ema_update(ema, g, ema_decay)
    return g, d, ema


def test_training_is_bitwise_the_same_with_the_ema_on():
    g_off, d_off, _ = _steps(3, None)
    g_on, d_on, ema = _steps(3, 0.999)
    for a, b in ((g_off, g_on), (d_off, d_on)):
        for (k, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            torch.testing.assert_close(x, y, rtol=0, atol=0, msg=k)
    # the EMA is not the trained weights
    assert any((ema[k] - p).abs().max() > 0
               for k, p in g_on.named_parameters())


def test_three_steps_with_the_ema_follow_make_dcgan_step():
    n = 3
    (g_model, g_state, d_state, _), (g, d, opt_g, opt_d) = _setup()
    step = make_dcgan_step(
        g_model, jax_dcgan.Discriminator(feature_maps=8, image_size=32),
        jax_adam(LR, 0.5), jax_adam(LR, 0.5), latent_dim=LATENT,
        donate=False, ema_decay=DECAY)
    images = _store(16, seed=3)
    idx = np.stack([(np.arange(B) + B * t) % 16 for t in range(n)])
    k_data = jax.random.key(5)
    store = torch.from_numpy(images)
    jax_ema = jax.tree_util.tree_map(jnp.copy, g_state.params)
    ema = init_ema(g)
    ours, theirs = [], []
    for t in range(n):
        key = jax.random.fold_in(k_data, t)
        g_state, d_state, jax_ema, m = step(
            g_state, d_state, jax_ema, jnp.asarray(images),
            jnp.asarray(idx[t]), key)
        theirs.append(np.asarray(m))
        flip, noise = _draws(key, B)
        ours.append(dcgan_step(
            g, d, opt_g, opt_d, store, torch.from_numpy(idx[t]).long(),
            latent_dim=LATENT, flip=flip, noise=noise).numpy())
        ema_update(ema, g, DECAY)
    _assert_traj("port dcgan metrics with EMA", np.stack(ours),
                 np.stack(theirs), atol=1e-4, early_atol=1e-4)
    bound = 2 * LR * n
    assert _param_drift(g_state.params, g.main, transpose_conv=True) < bound
    g_ema = Generator(LATENT, 3, 8, 32)
    g_ema.load_state_dict({**g.state_dict(), **ema})
    assert _param_drift(jax.device_get(jax_ema), g_ema.main,
                        transpose_conv=True) < bound


def test_ema_final_pairs_ema_params_with_raw_bn_buffers(fake_dataset,
                                                        tmp_path):
    out = tmp_path / "run"
    flags = ["--image-size", "32", "--feature-maps-g", "8",
             "--latent-dim", "16"]
    cli.main(["--cpu", "--data-dir", fake_dataset["data_dir"],
              "--model-dir", str(out / "models"),
              "--output-dir", str(out / "results"),
              "--results-dir", str(out / "metrics"),
              "--figures-dir", str(out / "figures"),
              "--cache-dir", str(out / "cache"), *flags,
              "--feature-maps-d", "8", "--epochs", "1", "--batch-size", "8",
              "--vis-batch-size", "8", "--ema-decay", "0.9"])
    gan_dir = out / "models" / "gan"
    raw = torch.load(gan_dir / "generator_final.pth", weights_only=True)
    ema = torch.load(gan_dir / "generator_ema_final.pth", weights_only=True)
    assert set(raw) == set(ema)
    params = {k for k, _ in Generator(16, 3, 8, 32).named_parameters()}
    assert all((raw[k] - ema[k]).abs().max() > 0 for k in params)
    for k in set(raw) - params:  # BN running statistics and counts
        torch.testing.assert_close(ema[k], raw[k], rtol=0, atol=0)
    stats = generate_synthetic.main([
        "--cpu", "--model-path", str(gan_dir / "generator_ema_final.pth"),
        "--output-dir", str(tmp_path / "synth"), "--num-images", "2",
        "--batch-size", "2", *flags])
    assert stats["written"] == 2


@pytest.mark.parametrize("value", ["1.0", "-0.1", "1.5"])
def test_ema_decay_out_of_range_is_refused(value):
    with pytest.raises(argparse.ArgumentTypeError) as ours:
        config.ema_decay(value)
    with pytest.raises(argparse.ArgumentTypeError) as theirs:
        jax_config._ema_decay(value)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(SystemExit) as e:
        cli.build_parser().parse_args(["--ema-decay", value])
    assert e.value.code == 2
    assert cli.build_parser().parse_args(
        ["--ema-decay", "0.999"]).ema_decay == 0.999
