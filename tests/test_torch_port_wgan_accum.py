"""xgan_torch's ``wgan_step(grad_accum=A)`` against the JAX package's
``make_wgan_step(grad_accum=A)``, from the same weights (carried across
by the port's converters) with the JAX step's draws injected (the flip,
each critic update's noise and α, G's noise, all over the full batch).

Three steps with plain SGD (lr 2e-4) on both sides: every step's losses
within 1e-4, so steps 2 and 3 read G and the critic after their
accumulated updates; these steps hold the accumulated update. Three
steps with the trainer's Adam hold only what Adam's first update leaves
comparable: the first critic loss (which reads no update) within 1e-4,
and BN statistics of G and the critic after step 1 within rtol 1e-4 /
atol 1e-5. They are not a parity check of the update: Adam's first
updates are ~lr * sign(g), so a coordinate whose gradient is rounding
noise moves by lr either way, and through the critic that moved every
later loss by up to 3e-3 absolute, where the SGD steps agree within
1e-7.

A in {2, 4}, each with no mask, a tail mask that leaves every microbatch
some valid rows, and one that leaves microbatches fully padded (frozen BN
statistics, a zero gradient). Beside it: A > 1 differs from A = 1 only
through BN granularity (as tests/test_wgan_grad_accum.py:214 holds the
JAX step), the trainer runs end to end with ``--grad-accum``, and an A
that does not divide the batch prints the JAX note and trains as A = 1."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_wgan_step import (FM, LAMBDA, LATENT, LR, SIZE,
                                             _draws, _reference_init,
                                             _store)
from tests.torch_port_util import bn_stats_from_torch
from xgan.models import wgan as jax_wgan
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan.train.wgan import make_wgan_step
from xgan_torch.cli import train_wggan as cli
from xgan_torch.models.convert import (critic_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.dcgan import SEQ_BN
from xgan_torch.models.wgan import SEQ_C_BN, Critic, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.wgan import wgan_step

torch.set_num_threads(1)

B, N_CRITIC = 16, 2


def _setup(accum, seed=0, sgd=False):
    g_model = jax_wgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                 image_size=SIZE)
    c_model = jax_wgan.Critic(feature_maps=FM, image_size=SIZE)
    if sgd:
        g_tx, c_tx = optax.sgd(LR), optax.sgd(LR)
    else:
        g_tx, c_tx = (jax_adam(LR, 0.5, beta2=0.9),
                      jax_adam(LR, 0.5, beta2=0.9))
    g_vars = _reference_init(g_model, jnp.zeros((2, LATENT)), seed)
    c_vars = _reference_init(c_model, jnp.zeros((2, SIZE, SIZE, 3)),
                             seed + 1)
    states = [ModelState(params=v[0], batch_stats=v[1],
                         opt_state=tx.init(v[0]))
              for v, tx in ((g_vars, g_tx), (c_vars, c_tx))]
    step = make_wgan_step(g_model, c_model, g_tx, c_tx, latent_dim=LATENT,
                          critic_iters=N_CRITIC, lambda_gp=LAMBDA,
                          donate=False, grad_accum=accum)
    g = Generator(LATENT, 3, FM, SIZE)
    g.load_state_dict(generator_state_dict_from_jax(*g_vars))
    c = Critic(3, FM, SIZE)
    c.load_state_dict(critic_state_dict_from_jax(*c_vars))
    if sgd:
        opts = (torch.optim.SGD(g.parameters(), LR),
                torch.optim.SGD(c.parameters(), LR))
    else:
        opts = (adam(g.parameters(), LR, 0.5, 0.9),
                adam(c.parameters(), LR, 0.5, 0.9))
    port = (g, c, *opts)
    return states, step, port


def _port_step(port, images, idx, draws, mask, accum):
    g, c, opt_g, opt_c = port
    return wgan_step(g, c, opt_g, opt_c, torch.from_numpy(images),
                     torch.from_numpy(idx).long(), latent_dim=LATENT,
                     critic_iters=N_CRITIC, lambda_gp=LAMBDA,
                     mask=None if mask is None else torch.from_numpy(mask),
                     grad_accum=accum, **draws)


@pytest.mark.parametrize("sgd", [True, False], ids=["sgd", "adam"])
@pytest.mark.parametrize("valid", [None, 13, 6], ids=["full", "tail",
                                                      "padded_micro"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accum_step_matches_jax(accum, valid, sgd):
    (g_state, c_state), step, port = _setup(accum, seed=2, sgd=sgd)
    images = _store(24, seed=4)
    order = np.random.default_rng(5).permutation(24)
    mask = None if valid is None else (np.arange(B) < valid).astype(
        np.float32)
    k_data = jax.random.key(6)
    n = 3
    for t in range(n):
        idx = np.roll(order, -7 * t)[:B]
        key = jax.random.fold_in(k_data, t)
        g_state, c_state, d_losses, g_loss = step(
            g_state, c_state, jnp.asarray(images), jnp.asarray(idx), key,
            mask=None if mask is None else jnp.asarray(mask))
        got = _port_step(port, images, idx, _draws(key, B), mask, accum)
        want = np.concatenate([np.asarray(d_losses), [float(g_loss)]])
        assert np.isfinite(got.numpy()).all()
        held = slice(None) if sgd else slice(0, 1 if t == 0 else 0)
        np.testing.assert_allclose(got.numpy()[held], want[held], rtol=0,
                                   atol=1e-4, err_msg=f"step {t + 1}")
        if t == 0:
            for model, seq, state in ((port[0], SEQ_BN, g_state),
                                      (port[1], SEQ_C_BN, c_state)):
                ours = bn_stats_from_torch(model, seq)
                for name, s in jax.device_get(state.batch_stats).items():
                    for k in ("mean", "var"):
                        np.testing.assert_allclose(
                            ours[name][k], s[k], rtol=1e-4, atol=1e-5,
                            err_msg=f"{name}.{k}")


def test_accum_changes_only_bn_granularity():
    """A = 2 against A = 1 on the same weights and draws: both finite and
    within 0.5 (BN statistics over microbatches of 8 shift the losses by
    O(0.1) at this init, a dropped 1/W would shift them ~A times)."""
    images = _store(20, seed=1)
    idx = np.arange(8)
    draws = _draws(jax.random.key(3), 8)
    out = {}
    for accum in (1, 2):
        _, _, port = _setup(accum, seed=0)
        out[accum] = _port_step(port, images, idx, draws, None,
                                accum).numpy()
        assert np.isfinite(out[accum]).all()
    np.testing.assert_allclose(out[2], out[1], rtol=0.5, atol=0.5)
    assert not np.array_equal(out[2], out[1])


def _cli(fake_dataset, out, *extra):
    return cli.main(["--cpu", "--data-dir", fake_dataset["data_dir"],
                     "--model-dir", str(out / "models"),
                     "--output-dir", str(out / "results"),
                     "--results-dir", str(out / "metrics"),
                     "--figures-dir", str(out / "figures"),
                     "--cache-dir", str(out / "cache"), "--image-size", "32",
                     "--feature-maps-g", "8", "--feature-maps-d", "8",
                     "--latent-dim", "16", "--epochs", "1",
                     "--batch-size", "16", "--vis-batch-size", "8",
                     "--critic-iters", "2", *extra])


def test_loop_runs_with_grad_accum(fake_dataset, tmp_path):
    """24 images at B = 16, A = 4: the tail batch's last two microbatches
    are all padding."""
    history = _cli(fake_dataset, tmp_path / "a4", "--grad-accum", "4")
    steps = math.ceil(fake_dataset["n_train"] / B)
    assert len(history["G_losses"]) == steps
    assert len(history["D_losses"]) == 2 * steps
    for series in history.values():
        assert np.isfinite(series).all()
    assert (tmp_path / "a4" / "models" / "wgan" /
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
