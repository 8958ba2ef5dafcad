"""xgan_torch's ``cgan_step`` against the JAX package's
(``xgan.train.cgan.make_cgan_step``), from the same weights (carried
across by the port's converters) with the JAX step's own draws injected:
``jax.random.split(key, 5)`` into the flip mask, the noise, the fake
labels and the real and fake targets (``xgan/train/cgan.py:82-96``).
f32, 32 px, widths 8, latent 8.

- One step: the 7 metrics within 1e-4 * (1 + |ref|).
- 10 steps in the envelope of tests/test_torch_trajectory.py: metrics
  within 1e-4 * (1 + |ref|) over the first 3 (measured 1.8e-6) and
  5e-2 * (1 + |ref|) over all (measured 2.5e-3: loss_G is O(100), and
  Adam's first steps turn rounding in near-zero gradients into ±lr
  moves); G's BN running statistics after step 3 (``_bn_stats_close``);
  parameter drift under 2 * lr * N.
- A masked tail step (16 rows, 8 valid, of a 24-image store): metrics
  within 1e-4 * (1 + |ref|), D's running statistics by
  ``_bn_stats_close``.
- The closed gate, through a D that adds an input-magnitude cue to its
  logits (the probe of tests/test_cgan.py:94-106): D's parameters and its
  Adam state (``exp_avg``, ``exp_avg_sq``, ``step``) bitwise unchanged
  while its BN statistics move; at epoch 0 the same inputs move the
  parameters.
- G's BN statistics advance once a step and D's four times; the G pass
  leaves no D weight gradient; without injected draws they come from
  ``generator`` in the documented order.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trajectory import STATS_T, _param_drift
from tests.torch_port_util import bn_stats_from_torch, jax_cgan
from xgan.models.vgg import VGG16Features as JaxVGG
from xgan.train.cgan import make_cgan_step
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan_torch.models import cgan as port_cgan
from xgan_torch.models.cgan import SEQ_D_BN, SEQ_G_BN, Discriminator, \
    Generator
from xgan_torch.models.convert import (cgan_discriminator_state_dict_from_jax,
                                       cgan_generator_state_dict_from_jax,
                                       vgg_state_dict_from_jax)
from xgan_torch.models.vgg import VGG16Features
from xgan_torch.train.cgan import cgan_step
from xgan_torch.train.common import adam

torch.set_num_threads(1)

LATENT, FM, SIZE, B, LR = 8, 8, 32, 4, 2e-4


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / (1 + np.abs(want)))


def _setup(seed=0):
    """The JAX states and step, and the port's models from the same
    weights with fresh Adam states.

    The weights are ``jax_cgan``'s unit-gain ones, not the reference init:
    with N(0, 0.02) conv weights beside U(±1/sqrt(fan_in)) biases, D's
    conv outputs are dominated by their bias, so a BN channel's mean is
    far above its spread, and the JAX package's one-pass variance
    ``E[x²] - E[x]²`` loses digits that torch's ``F.batch_norm`` (the
    port's unmasked train BN, the reference's BN) keeps: 3e-4 relative on
    D(G(z)) before any update. That compares the two BNs' rounding, not
    the step."""
    g_model, d_model, g_vars, d_vars = jax_cgan(LATENT, FM, SIZE, seed=seed)
    vgg_model = JaxVGG()
    g_tx, d_tx = jax_adam(LR, 0.5), jax_adam(LR, 0.5)
    g_state = ModelState(params=g_vars[0], batch_stats=g_vars[1],
                         opt_state=g_tx.init(g_vars[0]))
    d_state = ModelState(params=d_vars[0], batch_stats=d_vars[1],
                         opt_state=d_tx.init(d_vars[0]))
    vgg_params = jax.device_get(vgg_model.init(
        jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    step = make_cgan_step(g_model, d_model, vgg_model, g_tx, d_tx,
                          latent_dim=LATENT, donate=False)
    g = Generator(LATENT, 2, 3, FM, SIZE)
    g.load_state_dict(cgan_generator_state_dict_from_jax(*g_vars))
    d = Discriminator(2, 3, FM, SIZE)
    d.load_state_dict(cgan_discriminator_state_dict_from_jax(*d_vars))
    vgg = VGG16Features()
    vgg.load_state_dict(vgg_state_dict_from_jax(vgg_params))
    port = [g, d, vgg, adam(g.parameters(), LR, 0.5),
            adam(d.parameters(), LR, 0.5)]
    return (g_state, d_state, vgg_params, step), port


def _draws(key, b):
    """The JAX step's draws from ``key`` (xgan/train/cgan.py:82-96)."""
    k_flip, k_noise, k_lab, k_rs, k_fs = jax.random.split(key, 5)
    t = torch.from_numpy
    return {
        "flip": t(np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))),
        "noise": t(np.array(jax.random.normal(k_noise, (b, LATENT)))),
        "fake_labels": t(np.array(jax.random.randint(k_lab, (b,), 0, 2))
                         .astype(np.int64)),
        "real_targets": t(np.array(0.9 - 0.1 * jax.random.uniform(k_rs,
                                                                  (b,)))),
        "fake_targets": t(np.array(0.1 + 0.1 * jax.random.uniform(k_fs,
                                                                  (b,))))}


def _bn_stats_close(ours, theirs, steps):
    """Running statistics after ``steps`` Adam steps. The conv biases
    (and G's ``fc`` bias) right before a BN have a zero gradient, so Adam
    moves each by ±lr on the sign of rounding noise, and the two packages
    may pick opposite signs: the running means may differ by up to
    2 lr a step (momentum 0.1 weights them below that). The variances do
    not see a bias: within 1e-4 relative."""
    for name, s in jax.device_get(theirs).items():
        np.testing.assert_allclose(ours[name]["mean"], s["mean"], rtol=0,
                                   atol=2 * LR * steps, err_msg=name)
        np.testing.assert_allclose(ours[name]["var"], s["var"], rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def _store(n, seed):
    return np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3),
                                                np.uint8)


def _port_step(port, store, labels_all, idx, epoch, **kw):
    g, d, vgg, opt_g, opt_d = port
    return cgan_step(g, d, vgg, opt_g, opt_d, torch.from_numpy(store),
                     torch.from_numpy(labels_all.astype(np.int64)),
                     torch.from_numpy(np.asarray(idx)).long(), epoch,
                     latent_dim=LATENT, **kw)


def test_one_step_matches_make_cgan_step():
    (g_state, d_state, vgg_params, step), port = _setup()
    images = _store(16, seed=1)
    labels_all = (np.arange(16) % 2).astype(np.int32)
    idx = np.arange(B, dtype=np.int32) + 3
    key = jax.random.key(2)
    _, _, want = step(g_state, d_state, vgg_params, jnp.asarray(images),
                      jnp.asarray(labels_all), jnp.asarray(idx),
                      jnp.int32(0), key)
    got = _port_step(port, images, labels_all, idx, 0, **_draws(key, B))
    assert got.shape == (7,) and got.dtype == torch.float32
    want = np.asarray(want)
    assert want[0] > 1 and want[5] > 0 and want[6] > 0
    assert _rel(got.numpy(), want) <= 1e-4, (got.numpy(), want)


def test_trajectory_matches_make_cgan_step():
    n = 10
    (g_state, d_state, vgg_params, step), port = _setup(seed=3)
    images = _store(16, seed=13)
    labels_all = (np.arange(16) % 2).astype(np.int32)
    idx = np.stack([(np.arange(B) + B * t) % 16 for t in range(n)])
    k_data = jax.random.key(17)
    ours, theirs = [], []
    for t in range(n):
        key = jax.random.fold_in(k_data, t)
        g_state, d_state, m = step(
            g_state, d_state, vgg_params, jnp.asarray(images),
            jnp.asarray(labels_all), jnp.asarray(idx[t]), jnp.int32(0), key)
        theirs.append(np.asarray(m))
        ours.append(_port_step(port, images, labels_all, idx[t], 0,
                               **_draws(key, B)).numpy())
        if t == STATS_T - 1:
            _bn_stats_close(bn_stats_from_torch(port[0], SEQ_G_BN),
                            g_state.batch_stats, STATS_T)
    ours, theirs = np.stack(ours), np.stack(theirs)
    early, full = _rel(ours[:STATS_T], theirs[:STATS_T]), _rel(ours, theirs)
    print(f"[cgan port] early {early:.3e}, full {full:.3e}")
    assert early <= 1e-4, early
    assert full <= 5e-2, full
    g, d = port[:2]
    # the port's G convs are OIHW like the discriminator's
    assert _param_drift(g_state.params, g.main, transpose_conv=False) \
        < 2 * LR * n
    assert _param_drift(d_state.params, d.main, transpose_conv=False) \
        < 2 * LR * n


def test_masked_tail_step_matches_jax():
    """A wrap-padded tail batch of 16 rows over a 24-image store: the last
    8 rows out of every BN statistic, loss, metric and per-layer mean."""
    (g_state, d_state, vgg_params, step), port = _setup(seed=4)
    images = _store(24, seed=5)
    labels_all = (np.arange(24) % 2).astype(np.int32)
    idx = np.resize(np.random.default_rng(6).permutation(24), 40)[24:]
    mask = (np.arange(16) < 8).astype(np.float32)
    key = jax.random.key(7)
    _, d_state, want = step(g_state, d_state, vgg_params,
                            jnp.asarray(images), jnp.asarray(labels_all),
                            jnp.asarray(idx), jnp.int32(0), key,
                            mask=jnp.asarray(mask))
    got = _port_step(port, images, labels_all, idx, 0,
                     mask=torch.from_numpy(mask), **_draws(key, 16))
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-4
    _bn_stats_close(bn_stats_from_torch(port[1], SEQ_D_BN),
                    d_state.batch_stats, 1)


class CueProbe(Discriminator):
    """The port's discriminator plus an input-magnitude cue on its logits:
    constant-255 reals normalize to ~|2.2| while tanh fakes stay within 1,
    so ``20 mean(relu(|x| - 1.5)) - 5`` makes D(x) ~ 1 and D(G(z)) < 0.1
    with margins far above rounding (tests/test_cgan.py:78-106)."""

    def forward(self, x, labels, *, train, features=False, mask=None):
        out = super().forward(x, labels, train=train, features=features,
                              mask=mask)
        cue = 20.0 * torch.relu(x.float().abs() - 1.5).mean(dim=(1, 2, 3)) \
            - 5.0
        return (out[0] + cue, out[1]) if features else out + cue


def _probe_port(seed=8):
    gen = torch.Generator().manual_seed(seed)
    g = Generator(LATENT, 2, 3, FM, SIZE, generator=gen)
    d = CueProbe(2, 3, FM, SIZE, generator=gen)
    vgg = VGG16Features(generator=gen)
    return [g, d, vgg, adam(g.parameters(), LR, 0.5),
            adam(d.parameters(), LR, 0.5)]


def test_closed_gate_leaves_d_and_its_adam_state_untouched():
    port = _probe_port()
    images = np.full((16, SIZE, SIZE, 3), 255, np.uint8)
    labels_all = (np.arange(16) % 2).astype(np.int32)
    idx = np.arange(8)
    # one open step first (epoch 0), so Adam has moments and a step count
    m0 = _port_step(port, images, labels_all, idx, 0,
                    generator=torch.Generator().manual_seed(1))
    d, opt_d = port[1], port[4]
    params = copy.deepcopy(list(d.parameters()))
    state = copy.deepcopy(opt_d.state_dict())
    assert state["state"][0]["step"].item() == 1
    bn = [b.clone() for b in d.buffers()]
    snap = copy.deepcopy([port[0].state_dict(), d.state_dict(),
                          port[3].state_dict(), opt_d.state_dict()])

    m = _port_step(port, images, labels_all, idx, 10,
                   generator=torch.Generator().manual_seed(2)).numpy()
    assert m[2] > 0.9 and m[3] < 0.1, m  # the cue closes the gate
    for a, b in zip(d.parameters(), params):
        assert torch.equal(a, b)
    after = opt_d.state_dict()["state"]
    assert sorted(after) == sorted(state["state"])
    for i, s in state["state"].items():
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(after[i][k], s[k]), (i, k)
    moved = [not torch.equal(a, b) for a, b in zip(d.buffers(), bn)]
    assert any(moved)  # BN running statistics advance under a closed gate
    # the select form: D's backward ran, its update was selected away
    assert all(p.grad is not None for p in d.parameters())
    assert np.isfinite(m0.numpy()).all()

    # the same inputs at epoch 0: the gate is forced open, D moves
    for mod, sd in zip(port[:2] + port[3:], snap):
        mod.load_state_dict(sd)
    _port_step(port, images, labels_all, idx, 0,
               generator=torch.Generator().manual_seed(2))
    assert any(not torch.equal(a, b) for a, b in zip(d.parameters(),
                                                     params))
    assert opt_d.state_dict()["state"][0]["step"].item() == 2


def test_bn_advances_once_for_g_and_four_times_for_d(monkeypatch):
    port = _probe_port(seed=9)
    g, d = port[:2]
    calls = []
    bn_fn = port_cgan.batch_norm

    def spy(bn, x, *, train, mask=None, dim=1, update_stats=True):
        calls.append((id(bn), train and update_stats))
        return bn_fn(bn, x, train=train, mask=mask, dim=dim,
                     update_stats=update_stats)
    monkeypatch.setattr(port_cgan, "batch_norm", spy)
    _port_step(port, _store(8, 10), np.arange(8) % 2, np.arange(B), 0,
               generator=torch.Generator().manual_seed(3))
    per_bn = {}
    for key, train in calls:
        assert train
        per_bn[key] = per_bn.get(key, 0) + 1
    assert [per_bn[id(g.main[s])] for s in SEQ_G_BN] == [1] * 5
    assert [per_bn[id(d.main[s])] for s in SEQ_D_BN] == [4] * 4


def test_g_pass_leaves_no_d_weight_gradient():
    """D's gradients after the step are those its Adam step read: the G
    pass (D on the fake with features, then on the real) adds none."""
    port = _probe_port(seed=11)
    d, opt_d = port[1], port[4]
    seen = []
    step = opt_d.step

    def spy_step(*a, **k):
        seen.append([p.grad.clone() for p in d.parameters()])
        return step(*a, **k)
    opt_d.step = spy_step
    _port_step(port, _store(8, 12), np.arange(8) % 2, np.arange(B), 0,
               generator=torch.Generator().manual_seed(4))
    assert len(seen) == 1
    for p, g in zip(d.parameters(), seen[0]):
        assert torch.equal(p.grad, g)
    assert all(p.grad is not None for p in port[0].parameters())
    assert not any(p.requires_grad for p in port[2].parameters())


def test_draws_come_from_the_generator_in_order():
    """Without injected draws: flip, noise, fake labels, real targets, fake
    targets from ``generator``, in that order; the same seed gives the
    same step, bitwise."""
    images = _store(8, 14)
    labels_all = np.arange(8) % 2
    out = []
    for inject in (False, True):
        port = _probe_port(seed=15)
        gen = torch.Generator().manual_seed(16)
        kw = {"generator": gen}
        if inject:
            kw = {"flip": torch.rand(B, generator=gen) < 0.5,
                  "noise": torch.randn((B, LATENT), generator=gen),
                  "fake_labels": torch.randint(0, 2, (B,), generator=gen),
                  "real_targets": 0.9 - 0.1 * torch.rand(B, generator=gen),
                  "fake_targets": 0.1 + 0.1 * torch.rand(B, generator=gen)}
        out.append(_port_step(port, images, labels_all, np.arange(B), 0,
                              **kw))
    assert torch.isfinite(out[0]).all()
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
