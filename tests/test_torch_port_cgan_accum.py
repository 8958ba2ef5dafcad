"""xgan_torch's ``cgan_step(grad_accum=A)`` against the JAX package's
``make_cgan_step(grad_accum=A)``, from the same weights (carried across
by the port's converters) with the JAX step's draws injected (flip,
noise, fake labels, real and fake targets, all over the full batch), at
the tolerance of tests/test_torch_port_cgan_step.py: metrics within
1e-4 * (1 + |ref|).

- A in {2, 4}, each with no mask, a tail mask that leaves every
  microbatch some valid rows, and one (7 valid rows) that leaves
  microbatches fully padded: three steps with plain SGD (lr 2e-4) on
  both sides, every step's metrics held (steps 2 and 3 read G and D after
  their accumulated updates: these steps hold the accumulated update);
  and three steps with the trainer's Adam, of which only the first
  step's metrics are held. Both hold D's BN statistics after step 1
  (``_bn_stats_close``), which a fully padded microbatch that is not
  skipped would move. The Adam steps are not a parity check of the
  update: Adam's first updates are ~lr * sign(g), so a coordinate whose
  gradient is rounding noise moves by lr either way. Each microbatch
  that counts holds at least 3 valid rows: G's first BN sees a 1x1 map at 32 px, and over 2
  rows it is so ill-conditioned that a 1e-7 relative change of the noise
  moved the port's own G update by 1e-3 relative (6 valid rows at
  A = 4), where rounding alone parts the packages.
- The gate, through the input-magnitude cue of tests/test_cgan.py:94-106
  on both sides: held open at epoch 0 and closed at epoch 10 by the
  accumulated D(x) and D(G(z)), for A = 1 and A = 2. A closed gate
  leaves D's parameters and its Adam state bitwise unchanged under the
  device select while D's BN statistics move; the metrics match JAX's.
- The trainer runs end to end with ``--grad-accum``, and an A that does
  not divide the batch prints the JAX note and trains as A = 1."""
import copy
import math

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_torch_port_cgan_step import (FM, LATENT, LR, SIZE, CueProbe,
                                             _bn_stats_close, _draws, _rel,
                                             _store)
from tests.torch_port_util import bn_stats_from_torch, jax_cgan
from xgan.models.vgg import VGG16Features as JaxVGG
from xgan.train.cgan import make_cgan_step
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan_torch.cli import train_cgan as cli
from xgan_torch.models.cgan import SEQ_D_BN, Discriminator, Generator
from xgan_torch.models.convert import (cgan_discriminator_state_dict_from_jax,
                                       cgan_generator_state_dict_from_jax,
                                       vgg_state_dict_from_jax)
from xgan_torch.models.vgg import VGG16Features
from xgan_torch.train.cgan import cgan_step
from xgan_torch.train.common import adam

torch.set_num_threads(1)

B = 16


class GatedProbe(nn.Module):
    """The JAX side of ``CueProbe`` (tests/test_cgan.py:94-106)."""
    base: nn.Module

    @nn.compact
    def __call__(self, x, labels, *, train, features=False, mask=None):
        out = self.base(x, labels, train=train, features=features,
                        mask=mask)
        cue = 20.0 * jnp.mean(nn.relu(jnp.abs(x.astype(jnp.float32)) - 1.5),
                              axis=(1, 2, 3)) - 5.0
        return (out[0] + cue, out[1]) if features else out + cue


def _setup(accum, seed=0, sgd=False, probe=False):
    g_model, d_model, g_vars, d_vars = jax_cgan(LATENT, FM, SIZE, seed=seed)
    vgg_model = JaxVGG()
    if sgd:
        g_tx, d_tx = optax.sgd(LR), optax.sgd(LR)
    else:
        g_tx, d_tx = jax_adam(LR, 0.5), jax_adam(LR, 0.5)
    d_params, d_stats = d_vars
    if probe:
        d_model = GatedProbe(d_model)
        d_params, d_stats = {"base": d_params}, {"base": d_stats}
    g_state = ModelState(params=g_vars[0], batch_stats=g_vars[1],
                         opt_state=g_tx.init(g_vars[0]))
    d_state = ModelState(params=d_params, batch_stats=d_stats,
                         opt_state=d_tx.init(d_params))
    vgg_params = jax.device_get(vgg_model.init(
        jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    step = make_cgan_step(g_model, d_model, vgg_model, g_tx, d_tx,
                          latent_dim=LATENT, donate=False, grad_accum=accum)
    g = Generator(LATENT, 2, 3, FM, SIZE)
    g.load_state_dict(cgan_generator_state_dict_from_jax(*g_vars))
    d = (CueProbe if probe else Discriminator)(2, 3, FM, SIZE)
    d.load_state_dict(cgan_discriminator_state_dict_from_jax(*d_vars))
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(vgg_params))
    opt = (lambda p: torch.optim.SGD(p, LR)) if sgd else \
        (lambda p: adam(p, LR, 0.5))
    port = [g, d, vgg, opt(g.parameters()), opt(d.parameters())]
    return (g_state, d_state, vgg_params, step), port


def _port_step(port, images, labels_all, idx, epoch, mask, accum, key):
    g, d, vgg, opt_g, opt_d = port
    return cgan_step(g, d, vgg, opt_g, opt_d, torch.from_numpy(images),
                     torch.from_numpy(labels_all.astype(np.int64)),
                     torch.from_numpy(idx).long(), epoch,
                     latent_dim=LATENT,
                     mask=None if mask is None else torch.from_numpy(mask),
                     grad_accum=accum, **_draws(key, B))


@pytest.mark.parametrize("sgd", [True, False], ids=["sgd", "adam"])
@pytest.mark.parametrize("valid", [None, 13, 7], ids=["full", "tail",
                                                      "padded_micro"])
@pytest.mark.parametrize("accum", [2, 4])
def test_accum_step_matches_jax(accum, valid, sgd):
    (g_state, d_state, vgg_params, step), port = _setup(accum, seed=1,
                                                        sgd=sgd)
    images = _store(24, seed=2)
    labels_all = (np.arange(24) % 2).astype(np.int32)
    order = np.random.default_rng(3).permutation(24)
    mask = None if valid is None else (np.arange(B) < valid).astype(
        np.float32)
    k_data = jax.random.key(4)
    n = 3
    for t in range(n):
        idx = np.roll(order, -7 * t)[:B]
        key = jax.random.fold_in(k_data, t)
        g_state, d_state, want = step(
            g_state, d_state, vgg_params, jnp.asarray(images),
            jnp.asarray(labels_all), jnp.asarray(idx), jnp.int32(0), key,
            mask=None if mask is None else jnp.asarray(mask))
        got = _port_step(port, images, labels_all, idx, 0, mask, accum, key)
        assert np.isfinite(got.numpy()).all()
        if sgd or t == 0:
            assert _rel(got.numpy(), np.asarray(want)) <= 1e-4, \
                (t, got.numpy(), np.asarray(want))
        if t == 0:
            _bn_stats_close(bn_stats_from_torch(port[1], SEQ_D_BN),
                            d_state.batch_stats, 1)


@pytest.mark.parametrize("closed", [False, True], ids=["open", "closed"])
@pytest.mark.parametrize("accum", [1, 2])
def test_gate_matches_jax(accum, closed):
    """Constant-255 reals under the cue: D(x) ~ 1, D(G(z)) < 0.1, so the
    gate closes at epoch 10 and is held open at epoch 0. One open step
    first gives Adam moments and a step count."""
    (g_state, d_state, vgg_params, step), port = _setup(accum, seed=5,
                                                        probe=True)
    images = np.full((24, SIZE, SIZE, 3), 255, np.uint8)
    labels_all = (np.arange(24) % 2).astype(np.int32)
    idx = np.arange(B)
    for t, epoch in enumerate((0, 10 if closed else 0)):
        key = jax.random.key(6 + t)
        if t == 1:
            d, opt_d = port[1], port[4]
            params = copy.deepcopy(list(d.parameters()))
            state = copy.deepcopy(opt_d.state_dict()["state"])
            bn = [b.clone() for b in d.buffers()]
        g_state, d_state, want = step(
            g_state, d_state, vgg_params, jnp.asarray(images),
            jnp.asarray(labels_all), jnp.asarray(idx), jnp.int32(epoch),
            key)
        got = _port_step(port, images, labels_all, idx, epoch, None, accum,
                         key).numpy()
        assert _rel(got, np.asarray(want)) <= 1e-4, (t, got,
                                                     np.asarray(want))
    assert got[2] > 0.9 and got[3] < 0.1, got  # D(x), D(G(z)) of the gate
    same = [torch.equal(a, b) for a, b in zip(d.parameters(), params)]
    after = opt_d.state_dict()["state"]
    same_state = [torch.equal(after[i][k], s[k]) for i, s in state.items()
                  for k in ("exp_avg", "exp_avg_sq", "step")]
    if closed:
        assert all(same) and all(same_state)
        assert all(p.grad is not None for p in d.parameters())
    else:
        assert not all(same) and not all(same_state)
        assert after[0]["step"].item() == 2
    assert any(not torch.equal(a, b) for a, b in zip(d.buffers(), bn))


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
    assert (tmp_path / "a4" / "models" / "cgan" /
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
