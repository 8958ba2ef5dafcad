"""xgan_torch's WGAN-GP ``gradient_penalty`` and ``wgan_step`` against the
JAX package's (``xgan.train.wgan``), from the same weights (carried across
by the port's converters) with the JAX step's own draws injected: the flip
mask, each critic update's noise and α, and G's noise, as
``jax.random.split(fold_in(k_data, t), 3)`` and the per-update
``split(key_i)`` make them.

- The penalty, with and without a mask, and its gradient in the critic's
  parameters (the double backward through cuDNN's convolutions,
  ``F.batch_norm`` or the masked ``batch_norm_train``, and LeakyReLU):
  within 1e-4, the gradients within 1e-4 * (1 + max|ref|).
- 20 steps with ``critic_iters`` 2 in the envelope of
  tests/test_torch_trajectory.py (f32, 32 px, widths 8, B = 4): losses
  within 1e-4 over the first 3 steps and 0.3 over all 20 (Wasserstein
  losses are unbounded and the critic loop amplifies reduction-order
  noise); BN running statistics after step 3 within 1e-2 relative;
  parameter drift under 2 * lr * N * critic_iters for the critic and
  2 * lr * N for G (Adam's walk on near-zero gradients).
- One masked tail step (16 rows, 8 valid, of a 24-image store): losses
  within 1e-4.
- The step's order: one gather, G's train forward under ``no_grad`` before
  each critic update, the critic on real, fake and interpolated batches in
  that order, then G with gradients; and no ConvT of G on the penalty's
  graph.
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_trajectory import (STATS_T, _assert_traj,
                                         _param_drift, _stats_drift)
from tests.torch_port_util import (bn_stats_from_torch,
                                   discriminator_vars_from_torch,
                                   jax_discriminator)
from xgan.models import wgan as jax_wgan
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan.train.wgan import gradient_penalty as jax_gradient_penalty
from xgan.train.wgan import make_wgan_step
from xgan_torch.models.convert import (critic_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.dcgan import SEQ_BN
from xgan_torch.models.wgan import SEQ_C_BN, SEQ_C_CONV, Critic, Generator
from xgan_torch.train import wgan as port_wgan
from xgan_torch.train.common import adam
from xgan_torch.train.wgan import gradient_penalty, wgan_step

torch.set_num_threads(1)

LATENT, FM, SIZE, B, LR, N_CRITIC, LAMBDA = 8, 8, 32, 4, 2e-4, 2, 10.0


def _reference_init(model, example, seed):
    """Flax variables (numpy leaves) with the reference GAN init: N(0,
    0.02) conv kernels, N(1, 0.02) BN scales, zero BN biases, running
    mean 0 and variance 1."""
    like = jax.eval_shape(partial(model.init, train=False),
                          jax.random.key(0), example)
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for name, leaf in like["params"].items():
        if name.startswith(("Conv", "ConvTranspose")):
            params[name] = {"kernel": rng.normal(
                0, 0.02, leaf["kernel"].shape).astype(np.float32)}
        else:
            c = leaf["scale"].shape[0]
            params[name] = {
                "scale": rng.normal(1, 0.02, c).astype(np.float32),
                "bias": np.zeros(c, np.float32)}
            stats[name] = {"mean": np.zeros(c, np.float32),
                           "var": np.ones(c, np.float32)}
    return params, stats


def _setup(seed=0, n_critic=N_CRITIC):
    g_model = jax_wgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                 image_size=SIZE)
    c_model = jax_wgan.Critic(feature_maps=FM, image_size=SIZE)
    g_tx, c_tx = jax_adam(LR, 0.5, beta2=0.9), jax_adam(LR, 0.5, beta2=0.9)
    g_vars = _reference_init(g_model, jnp.zeros((2, LATENT)), seed)
    c_vars = _reference_init(c_model, jnp.zeros((2, SIZE, SIZE, 3)),
                             seed + 1)
    g_state = ModelState(params=g_vars[0], batch_stats=g_vars[1],
                         opt_state=g_tx.init(g_vars[0]))
    c_state = ModelState(params=c_vars[0], batch_stats=c_vars[1],
                         opt_state=c_tx.init(c_vars[0]))
    step = make_wgan_step(g_model, c_model, g_tx, c_tx, latent_dim=LATENT,
                          critic_iters=n_critic, lambda_gp=LAMBDA,
                          donate=False)
    g = Generator(LATENT, 3, FM, SIZE)
    g.load_state_dict(generator_state_dict_from_jax(*g_vars))
    c = Critic(3, FM, SIZE)
    c.load_state_dict(critic_state_dict_from_jax(*c_vars))
    # Adam betas (beta1, 0.9), as the JAX trainer
    return (g_state, c_state, step), (g, c, adam(g.parameters(), LR, 0.5,
                                                 0.9),
                                      adam(c.parameters(), LR, 0.5, 0.9))


def _draws(key, b, n_critic=N_CRITIC):
    """The JAX step's draws from ``key``: the flip mask, per critic update
    its noise and α, then G's noise."""
    k_flip, k_critic, k_g = jax.random.split(key, 3)
    noises, alphas = [], []
    for key_i in jax.random.split(k_critic, n_critic):
        k_noise, k_alpha = jax.random.split(key_i)
        noises.append(np.array(jax.random.normal(k_noise, (b, LATENT))))
        alphas.append(np.array(jax.random.uniform(k_alpha, (b, 1, 1, 1),
                                                  jnp.float32)))
    t = torch.from_numpy
    return {"flip": t(np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))),
            "noises": [t(n) for n in noises],
            "alphas": [t(a) for a in alphas],
            "g_noise": t(np.array(jax.random.normal(k_g, (b, LATENT))))}


def _store(n, seed):
    return np.random.default_rng(seed).integers(0, 255, (n, SIZE, SIZE, 3),
                                                np.uint8)


def _step(port, store, idx, draws, mask=None, n_critic=N_CRITIC):
    g, c, opt_g, opt_c = port
    return wgan_step(g, c, opt_g, opt_c, store, idx, latent_dim=LATENT,
                     critic_iters=n_critic, lambda_gp=LAMBDA, mask=mask,
                     **draws)


def _nodes(t):
    """Type names of every autograd node behind ``t``."""
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(nxt for nxt, _ in fn.next_functions)
    return {type(fn).__name__ for fn in seen}


@pytest.mark.parametrize("valid", [4, 3])
def test_gradient_penalty_matches_jax(valid):
    """The penalty and its gradient in the critic's parameters (the double
    backward) against ``jax.grad`` of the JAX penalty; ``valid`` 3 masks
    the last row (the masked BN path), 4 passes no mask (F.batch_norm)."""
    model, params, stats = jax_discriminator(FM, SIZE, seed=1,
                                             family=jax_wgan)
    rng = np.random.default_rng(2)
    real = rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)
    fake = np.tanh(rng.normal(size=(B, SIZE, SIZE, 3))).astype(np.float32)
    alpha = rng.random((B, 1, 1, 1)).astype(np.float32)
    mask = None if valid == B else (np.arange(B) < valid).astype(np.float32)
    mkw = {} if mask is None else {"mask": jnp.asarray(mask)}

    def jax_gp(p):
        def critic_on(x):
            scores, upd = model.apply({"params": p, "batch_stats": stats},
                                      x, train=True, mutable=["batch_stats"],
                                      **mkw)
            return scores, upd["batch_stats"]
        return jax_gradient_penalty(
            critic_on, jnp.asarray(real), jnp.asarray(fake), None, LAMBDA,
            None if mask is None else jnp.asarray(mask),
            alpha=jnp.asarray(alpha))

    (want, want_stats), want_grads = jax.jit(jax.value_and_grad(
        jax_gp, has_aux=True))(params)

    c = Critic(3, FM, SIZE)
    c.load_state_dict(critic_state_dict_from_jax(params, stats))
    t = torch.from_numpy
    gp = gradient_penalty(c, t(real), t(fake), t(alpha), LAMBDA,
                          None if mask is None else t(mask))
    assert gp.shape == () and float(want) > 1.0
    assert abs(gp.item() - float(want)) <= 1e-4, (gp.item(), float(want))
    gp.backward()
    grads = {}
    for i, seq in enumerate(SEQ_C_CONV):
        grads[f"Conv_{i}"] = {"kernel": np.transpose(
            c.main[seq].weight.grad.numpy(), (2, 3, 1, 0))}
    for i, seq in enumerate(SEQ_C_BN):
        grads[f"TorchBatchNorm_{i}"] = {
            "scale": c.main[seq].weight.grad.numpy(),
            "bias": c.main[seq].bias.grad.numpy()}
    for name, leaves in want_grads.items():
        for k, v in leaves.items():
            v = np.asarray(v)
            tol = 1e-4 * (1 + np.abs(v).max())
            err = np.abs(grads[name][k] - v).max()
            assert err <= tol, f"d gp / d {name}.{k}: {err:.3g} > {tol:.3g}"
    ours = bn_stats_from_torch(c, SEQ_C_BN)
    for name, s in want_stats.items():
        for k in ("mean", "var"):
            np.testing.assert_allclose(ours[name][k], np.asarray(s[k]),
                                       rtol=1e-5, atol=1e-6)


def test_gradient_penalty_interpolates_in_f32():
    """x̂ is f32 for a bf16 real (JAX's promotion); with a critic that
    sums its input, every gradient is 1 and the penalty is
    λ·(sqrt(S·S·3) − 1)²."""
    seen = []

    def critic(x, train, mask=None):
        seen.append((x.dtype, x.requires_grad, train))
        return x.float().sum(dim=(1, 2, 3))

    real = torch.randn(B, 8, 8, 3).bfloat16()
    gp = gradient_penalty(critic, real, torch.rand(B, 8, 8, 3),
                          torch.rand(B, 1, 1, 1), LAMBDA)
    assert seen == [(torch.float32, True, True)]
    want = LAMBDA * (np.sqrt(8 * 8 * 3) - 1) ** 2
    assert abs(gp.item() - want) <= 1e-6 * want


def test_trajectory_matches_make_wgan_step():
    n = 20
    (g_state, c_state, step), port = _setup()
    images = _store(16, seed=7)
    idx = np.stack([(np.arange(B) + B * t) % 16 for t in range(n)])
    k_data = jax.random.key(11)
    store = torch.from_numpy(images)

    ours, theirs_d, theirs_g = [], [], []
    for t in range(n):
        key = jax.random.fold_in(k_data, t)
        g_state, c_state, d_losses, g_loss = step(
            g_state, c_state, jnp.asarray(images), jnp.asarray(idx[t]), key)
        theirs_d.append(np.asarray(d_losses))
        theirs_g.append(float(g_loss))
        got = _step(port, store, torch.from_numpy(idx[t]).long(),
                    _draws(key, B))
        assert got.shape == (N_CRITIC + 1,)
        ours.append(got.numpy())
        if t == STATS_T - 1:
            jax_stats = jax.device_get((g_state.batch_stats,
                                        c_state.batch_stats))
            g, c = port[:2]
            port_stats = ([(s["mean"], s["var"]) for s in
                           bn_stats_from_torch(g, SEQ_BN).values()],
                          [(s["mean"], s["var"]) for s in
                           bn_stats_from_torch(c, SEQ_C_BN).values()])
    ours = np.stack(ours)
    _assert_traj("port wgan d_losses", ours[:, :-1], np.stack(theirs_d),
                 atol=0.3, early_atol=1e-4)
    _assert_traj("port wgan g_loss", ours[:, -1], np.asarray(theirs_g),
                 atol=0.3, early_atol=1e-4)
    assert _stats_drift(jax_stats[0], port_stats[0]) < 1e-2
    assert _stats_drift(jax_stats[1], port_stats[1]) < 1e-2
    g, c = port[:2]
    assert _param_drift(c_state.params, c.main, transpose_conv=False) \
        < 2 * LR * n * N_CRITIC
    assert _param_drift(g_state.params, g.main, transpose_conv=True) \
        < 2 * LR * n


def test_masked_tail_step_matches_jax():
    """A wrap-padded tail batch of 16 rows over a 24-image store, the last
    8 rows masked out of every BN statistic, loss mean and the penalty."""
    (g_state, c_state, step), port = _setup(seed=1)
    images = _store(24, seed=4)
    idx = np.resize(np.random.default_rng(5).permutation(24), 40)[24:]
    mask = (np.arange(16) < 8).astype(np.float32)
    key = jax.random.key(6)
    g_state, c_state, d_losses, g_loss = step(
        g_state, c_state, jnp.asarray(images), jnp.asarray(idx), key,
        mask=jnp.asarray(mask))
    got = _step(port, torch.from_numpy(images), torch.from_numpy(idx).long(),
                _draws(key, 16), mask=torch.from_numpy(mask))
    want = np.concatenate([np.asarray(d_losses), [float(g_loss)]])
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    params, stats = discriminator_vars_from_torch(port[1], SEQ_C_CONV,
                                                  SEQ_C_BN)
    want_s = jax.device_get(c_state.batch_stats)
    for name in want_s:
        for k, v in want_s[name].items():
            np.testing.assert_allclose(stats[name][k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=f"{name}.{k}")
    # two Adam steps: a coordinate moves by up to lr a step whatever the
    # sign the noise gives a near-zero gradient
    assert _param_drift(c_state.params, port[1].main,
                        transpose_conv=False) < 2 * LR * N_CRITIC
    assert _param_drift(g_state.params, port[0].main,
                        transpose_conv=True) < 2 * LR


def test_step_order_and_no_convt_on_the_penalty_graph(monkeypatch):
    """One gather per step; before each critic update G's train forward
    under ``no_grad`` (its BN statistics advance), then the critic on the
    real, the fake and the interpolated batch (x̂ the one input that
    needs a gradient); then G with gradients and the critic once more. No
    ``ConvT4x4s2Train`` node on any penalty's graph; the G loss has one."""
    n_critic = 3
    _, port = _setup(seed=2, n_critic=n_critic)
    g, c = port[:2]
    calls, gp_nodes = [], []
    gather = port_wgan.gather_preprocess
    monkeypatch.setattr(port_wgan, "gather_preprocess", lambda *a, **k: (
        calls.append("gather"), gather(*a, **k))[1])
    penalty = port_wgan.gradient_penalty

    def spy_penalty(*a, **k):
        gp = penalty(*a, **k)
        gp_nodes.append(_nodes(gp))
        return gp
    monkeypatch.setattr(port_wgan, "gradient_penalty", spy_penalty)
    g_train, c_forward = g.forward_train, c.forward

    def spy_g(*a, **k):
        calls.append(("G", torch.is_grad_enabled()))
        return g_train(*a, **k)

    def spy_c(x, *, train, mask=None):
        calls.append(("C", train, x.requires_grad))
        return c_forward(x, train=train, mask=mask)
    monkeypatch.setattr(g, "forward_train", spy_g)
    monkeypatch.setattr(c, "forward", spy_c)
    g_stats = g.main[SEQ_BN[0]].running_mean.clone()
    loss = wgan_step(g, c, port[2], port[3], torch.from_numpy(_store(8, 3)),
                     torch.arange(B), latent_dim=LATENT,
                     critic_iters=n_critic, lambda_gp=LAMBDA,
                     generator=torch.Generator().manual_seed(4))
    assert loss.shape == (n_critic + 1,) and torch.isfinite(loss).all()
    update = [("G", False), ("C", True, False), ("C", True, False),
              ("C", True, True)]
    assert calls == (["gather"] + update * n_critic
                     + [("G", True), ("C", True, True)])
    assert not torch.equal(g.main[SEQ_BN[0]].running_mean, g_stats)
    assert len(gp_nodes) == n_critic
    for names in gp_nodes:
        assert "ConvolutionBackwardBackward0" in names  # the double backward
        assert not any("ConvT4x4s2Train" in n for n in names)
    z = torch.randn(B, LATENT)
    assert "ConvT4x4s2TrainBackward" in _nodes(
        c(g.forward_train(z), train=True))


def test_step_takes_its_draws_from_the_generator():
    """Without injected draws they come from ``generator``: the same seed
    gives the same step."""
    images = torch.from_numpy(_store(8, seed=8))
    out = []
    for _ in range(2):
        g = Generator(LATENT, 3, FM, SIZE,
                      generator=torch.Generator().manual_seed(0))
        c = Critic(3, FM, SIZE, generator=torch.Generator().manual_seed(1))
        m = wgan_step(g, c, adam(g.parameters(), LR, 0.5, 0.9),
                      adam(c.parameters(), LR, 0.5, 0.9), images,
                      torch.arange(B), latent_dim=LATENT, critic_iters=2,
                      lambda_gp=LAMBDA,
                      generator=torch.Generator().manual_seed(2))
        assert m.shape == (3,) and torch.isfinite(m).all()
        out.append(m)
    torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)
