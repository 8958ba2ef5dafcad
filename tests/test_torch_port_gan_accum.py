"""xgan_torch's ``dcgan_step(grad_accum=A)`` against the JAX package's
``make_dcgan_step(grad_accum=A)``, from the same weights (carried across
by the port's converters) with the JAX step's flip and noise draws
injected, at the tolerances of tests/test_torch_port_gan_step.py: the
metrics of three steps within 1e-4 (those of steps 2 and 3 read G after
its accumulated updates, so they hold the G phase), BN statistics of D
and G after the first step within 1e-4 relative, parameters within
2 * lr * N (an extra bound: Adam moves a coordinate whose gradient is
near its eps by up to lr whichever way the summation order rounds that
gradient, and the microbatched sums run in another order than the JAX
scan's).

A in {2, 4}, each with no mask, a tail mask that leaves every microbatch
some valid rows, and one that leaves microbatches fully padded (frozen BN
statistics, a zero gradient). Beside it: G's running statistics advance
once per microbatch (the G phase's recompute does not advance them
again), the trainer runs end to end with ``--grad-accum``, and an A that
does not divide the batch prints the JAX note and trains as A = 1."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_gan_step import (LATENT, LR, _draws, _setup,
                                            _store)
from tests.test_torch_trajectory import _param_drift
from tests.torch_port_util import (bn_stats_from_torch,
                                   discriminator_vars_from_torch)
from xgan.models import dcgan as jax_dcgan
from xgan.train.common import adam as jax_adam
from xgan.train.gan import make_dcgan_step
from xgan_torch.cli import train_gan as cli
from xgan_torch.models.dcgan import SEQ_BN
from xgan_torch.train.gan import dcgan_step

torch.set_num_threads(1)

B = 16


@pytest.mark.parametrize("valid", [None, 13, 6], ids=["full", "tail",
                                                      "padded_micro"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accum_step_matches_jax(accum, valid):
    """Three accumulated steps, each with the same mask: every step's
    metrics within 1e-4, so the metrics of steps 2 and 3 (D's losses on
    fakes from G after its accumulated updates) hold G's phase against
    the JAX step; the BN statistics after step 1 as above."""
    (g_model, g_state, d_state, _), (g, d, opt_g, opt_d) = _setup(seed=2)
    step = make_dcgan_step(
        g_model, jax_dcgan.Discriminator(feature_maps=8, image_size=32),
        jax_adam(LR, 0.5), jax_adam(LR, 0.5), latent_dim=LATENT,
        donate=False, grad_accum=accum)
    images = _store(24, seed=4)
    order = np.random.default_rng(5).permutation(24)
    mask = None if valid is None else (np.arange(B) < valid).astype(
        np.float32)
    k_data = jax.random.key(6)
    n = 3
    for t in range(n):
        idx = np.roll(order, -7 * t)[:B]
        key = jax.random.fold_in(k_data, t)
        g_state, d_state, want = step(
            g_state, d_state, jnp.asarray(images), jnp.asarray(idx), key,
            mask=None if mask is None else jnp.asarray(mask))
        flip, noise = _draws(key, B)
        got = dcgan_step(g, d, opt_g, opt_d, torch.from_numpy(images),
                         torch.from_numpy(idx).long(), latent_dim=LATENT,
                         mask=None if mask is None else torch.from_numpy(
                             mask), flip=flip, noise=noise,
                         grad_accum=accum)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-4, err_msg=f"step {t + 1}")
        if t == 0:
            _assert_bn_stats(g, d, g_state, d_state)
    assert _param_drift(d_state.params, d.main, transpose_conv=False) < \
        2 * LR * n
    assert _param_drift(g_state.params, g.main, transpose_conv=True) < \
        2 * LR * n


def _assert_bn_stats(g, d, g_state, d_state):
    _, stats = discriminator_vars_from_torch(d)
    for name, s in jax.device_get(d_state.batch_stats).items():
        for k, v in s.items():
            np.testing.assert_allclose(stats[name][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}.{k}")
    g_stats = bn_stats_from_torch(g, SEQ_BN)
    for name, s in jax.device_get(g_state.batch_stats).items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(g_stats[name][k], s[k], rtol=1e-4,
                                       atol=1e-5, err_msg=f"G {name}.{k}")


def test_g_running_stats_advance_once_per_microbatch():
    """G's first BN after an A = 2 step is two momentum updates, one per
    microbatch of the D phase: the G phase's recompute leaves it."""
    (_, _, _, _), (g, d, opt_g, opt_d) = _setup(seed=3)
    bn = g.main[SEQ_BN[0]]
    mean, var = bn.running_mean.clone(), bn.running_var.clone()
    images = torch.from_numpy(_store(16, seed=7))
    noise = torch.from_numpy(np.random.default_rng(8).normal(
        size=(B, LATENT)).astype(np.float32))
    with torch.no_grad():
        for half in noise.split(B // 2):
            x = half @ g._w0_mat()  # at 32 px the first map is 1x1
            mean = 0.9 * mean + 0.1 * x.mean(0)
            var = 0.9 * var + 0.1 * x.var(0, unbiased=True)
    dcgan_step(g, d, opt_g, opt_d, images, torch.arange(B),
               latent_dim=LATENT, flip=torch.zeros(B, dtype=torch.bool),
               noise=noise, grad_accum=2)
    torch.testing.assert_close(bn.running_mean, mean, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(bn.running_var, var, rtol=1e-5, atol=1e-6)


def _cli(fake_dataset, out, *extra):
    return cli.main(["--cpu", "--data-dir", fake_dataset["data_dir"],
                     "--model-dir", str(out / "models"),
                     "--output-dir", str(out / "results"),
                     "--results-dir", str(out / "metrics"),
                     "--figures-dir", str(out / "figures"),
                     "--cache-dir", str(out / "cache"), "--image-size", "32",
                     "--feature-maps-g", "8", "--feature-maps-d", "8",
                     "--latent-dim", "16", "--epochs", "1",
                     "--batch-size", "16", "--vis-batch-size", "8", *extra])


def test_loop_runs_with_grad_accum(fake_dataset, tmp_path):
    """24 images at B = 16, A = 4: the tail batch's last two microbatches
    are all padding."""
    history = _cli(fake_dataset, tmp_path / "a4", "--grad-accum", "4")
    steps = math.ceil(fake_dataset["n_train"] / B)
    assert len(history["G_losses_iter"]) == steps
    for series in history.values():
        assert np.isfinite(series).all()
    assert (tmp_path / "a4" / "models" / "gan" /
            "generator_final.pth").exists()


def test_non_dividing_accum_prints_the_note_and_runs_unaccumulated(
        fake_dataset, tmp_path, capsys):
    plain = _cli(fake_dataset, tmp_path / "plain")
    capsys.readouterr()
    noted = _cli(fake_dataset, tmp_path / "a3", "--grad-accum", "3")
    out = capsys.readouterr().out
    assert ("Note: --grad-accum 3 does not divide the (device-padded) "
            "batch size 16; running without accumulation.") in out
    assert noted == plain
