"""Three parts of xgan_torch's data parallelism on two gloo ranks on the
CPU (``tests/torch_port_dist_worker.py``, one launch of two processes):

- C10, the ranks' BN moments (Chan's combine, ``xgan_torch/ops/norm.py``):
  train-mode BN of channels whose mean is 1e3 to 1e4 times their spread,
  across two ranks, equals one process's ``F.batch_norm`` over the whole
  batch (in float64, on the same f32 inputs) within 1e-6 relative: the
  output, the input gradient, the scale and bias gradients and the
  running statistics, unmasked, masked, and with rank 1's rows all
  masked. The one-pass ``s2/n - mean^2`` the ranks took before loses
  every digit of such a variance.
- ZeRO-1 (``--shard-opt-state``, ``xgan_torch/parallel/tp.py``): the
  DCGAN's, WGAN-GP's (the penalty's double backward included) and CGAN's
  parameters after 3 steps, and the classifier's with its base frozen
  and unfrozen, bitwise equal to replicated Adam on the same ranks; each
  rank keeps 1/2 of every wide moment and the whole of every narrow one
  (tests/test_zero1.py:77's ask of the JAX package); a sharded run whose
  optimizers go through their whole state dict after its first step
  ends bitwise where the uninterrupted one does.
- ``--steps-per-call``: the three GAN steps as one K = 2 call of
  ``StepsPerCall`` on two ranks equal two single steps on them within
  tests/test_multistep.py's limits (rtol 2e-4, atol 2e-5), and the JAX
  package's K-step program on a 2-device mesh (``steps_per_call=2``),
  fed its own draws: the metrics at those limits, the parameters within
  the cross-package envelope of tests/test_torch_port_dist_wgan.py (every
  element within 2 lr an Adam step, all but 1 in 1000 at
  tests/test_sharding.py's parameter limits); the CGAN's within 3 lr an
  Adam step (tests/test_torch_port_dist_cgan.py's bound), see the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from tests.test_torch_port_cgan_step import _draws as cgan_draws
from tests.test_torch_port_dist_wgan import _params_close as wgan_close
from tests.test_torch_port_wgan_step import _draws as wgan_draws
from tests.test_torch_port_wgan_step import _reference_init
from tests.torch_port_dist_worker import run_cases
from tests.torch_port_util import jax_cgan
from xgan.models import dcgan as jax_dcgan
from xgan.models import wgan as jax_wgan
from xgan.models.vgg import VGG16Features as JaxVGG
from xgan.parallel import create_mesh
from xgan.train.cgan import make_cgan_step
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan.train.gan import make_dcgan_step
from xgan.train.wgan import make_wgan_step
from xgan_torch.models.convert import (
    cgan_discriminator_state_dict_from_jax,
    cgan_generator_state_dict_from_jax, critic_state_dict_from_jax,
    discriminator_state_dict_from_jax, generator_state_dict_from_jax,
    vgg_state_dict_from_jax)
from xgan_torch.models.resnet import ResNet50

torch.set_num_threads(1)

LATENT, FM, SIZE, B, LR, N, K = 8, 8, 32, 8, 2e-4, 16, 2
STEPS = 3  # ZeRO-1's steps
MIN = 16   # the rule's width here: G's 8-channel layer and RGB stay narrow
LOOP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_multistep.py:17
PARAMS_TOL = dict(rtol=2e-3, atol=2e-5)   # tests/test_sharding.py:55
KINDS = ("dcgan", "wgan", "cgan")
CLF_RUNS = {"clf_frozen": True, "clf_unfrozen": False}


def _dcgan_draws(key, b):
    """The JAX DCGAN step's flip and noise from ``key``."""
    k_flip, k_noise = jax.random.split(key)
    t = torch.from_numpy
    return {"flip": t(np.array(jax.random.bernoulli(k_flip, 0.5, (b,)))),
            "noise": t(np.array(jax.random.normal(k_noise, (b, LATENT))))}


def _replicated(mesh, variables, tx):
    return mesh.replicate(ModelState(params=variables[0],
                                     batch_stats=variables[1],
                                     opt_state=tx.init(variables[0])))


def _jax_runs(mesh, images, labels, chunk, key):
    """Each GAN's K-step program on the mesh: its initial (G, D) state
    dicts, its (K, M) metrics and final state dicts, and the port's draws
    of each step (``fold_in(key, t)``)."""
    out = {}
    sharding = mesh.batch_sharding(4)
    imgs = mesh.replicate(jnp.asarray(images))
    keys = [jax.random.fold_in(key, t) for t in range(STEPS)]

    g_model = jax_dcgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                  image_size=SIZE)
    d_model = jax_dcgan.Discriminator(feature_maps=FM, image_size=SIZE)
    g_vars = _reference_init(g_model, jnp.zeros((2, LATENT)), 60)
    d_vars = _reference_init(d_model, jnp.zeros((2, SIZE, SIZE, 3)), 61)
    tx = jax_adam(LR, 0.5)
    multi = make_dcgan_step(g_model, d_model, tx, tx, latent_dim=LATENT,
                            batch_sharding=sharding, donate=False,
                            steps_per_call=K)
    g, d, m = multi(_replicated(mesh, g_vars, tx),
                    _replicated(mesh, d_vars, tx), imgs, chunk,
                    jnp.int32(0), key)
    out["dcgan"] = {
        "init": (generator_state_dict_from_jax(*g_vars),
                 discriminator_state_dict_from_jax(*d_vars)),
        "metrics": np.asarray(m),
        "final": (generator_state_dict_from_jax(*jax.device_get(
            (g.params, g.batch_stats))), discriminator_state_dict_from_jax(
            *jax.device_get((d.params, d.batch_stats)))),
        "draws": [_dcgan_draws(k, B) for k in keys]}

    g_model = jax_wgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                 image_size=SIZE)
    c_model = jax_wgan.Critic(feature_maps=FM, image_size=SIZE)
    g_vars = _reference_init(g_model, jnp.zeros((2, LATENT)), 62)
    c_vars = _reference_init(c_model, jnp.zeros((2, SIZE, SIZE, 3)), 63)
    tx = jax_adam(LR, 0.5, beta2=0.9)
    multi = make_wgan_step(g_model, c_model, tx, tx, latent_dim=LATENT,
                           critic_iters=2, lambda_gp=10.0,
                           batch_sharding=sharding, donate=False,
                           steps_per_call=K)
    g, c, d_l, g_l = multi(_replicated(mesh, g_vars, tx),
                           _replicated(mesh, c_vars, tx), imgs, chunk,
                           jnp.int32(0), key)
    out["wgan"] = {
        "init": (generator_state_dict_from_jax(*g_vars),
                 critic_state_dict_from_jax(*c_vars)),
        "metrics": np.concatenate([np.asarray(d_l).reshape(K, -1),
                                   np.asarray(g_l).reshape(K, 1)], 1),
        "final": (generator_state_dict_from_jax(*jax.device_get(
            (g.params, g.batch_stats))), critic_state_dict_from_jax(
            *jax.device_get((c.params, c.batch_stats)))),
        "draws": [wgan_draws(k, B) for k in keys]}

    g_model, d_model, g_vars, d_vars = jax_cgan(LATENT, FM, SIZE, seed=64)
    vgg_model = JaxVGG()
    vgg_params = jax.device_get(vgg_model.init(
        jax.random.key(65), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    tx = jax_adam(LR, 0.5)
    multi = make_cgan_step(g_model, d_model, vgg_model, tx, tx,
                           latent_dim=LATENT, batch_sharding=sharding,
                           donate=False, steps_per_call=K)
    g, d, m = multi(_replicated(mesh, g_vars, tx),
                    _replicated(mesh, d_vars, tx),
                    mesh.replicate(vgg_params), imgs,
                    mesh.replicate(jnp.asarray(labels)), chunk,
                    jnp.int32(0), jnp.int32(0), key)
    out["cgan"] = {
        "init": (cgan_generator_state_dict_from_jax(*g_vars),
                 cgan_discriminator_state_dict_from_jax(*d_vars)),
        "metrics": np.asarray(m),
        "final": (cgan_generator_state_dict_from_jax(*jax.device_get(
            (g.params, g.batch_stats))),
            cgan_discriminator_state_dict_from_jax(*jax.device_get(
                (d.params, d.batch_stats)))),
        "draws": [cgan_draws(k, B) for k in keys],
        "vgg": vgg_state_dict_from_jax(vgg_params)}
    return out


def _bn_inputs():
    """(8, 3, 3, 6) NHWC rows whose channel means are 1e3 to 1e4 times
    their spreads (spreads 1e-2 to 1), a cotangent, a BN's state."""
    rng = np.random.default_rng(66)
    spread = np.array([1e-2, 0.1, 1.0, 0.03, 0.5, 0.2])
    ratio = np.array([1e3, 3e3, 1e4, 5e3, 2e3, 8e3])
    x = (spread * ratio + spread * rng.normal(size=(8, 3, 3, 6)))
    bn = nn.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                           .manual_seed(67))
        bn.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(68))
        bn.running_mean.copy_(torch.from_numpy(spread * ratio * 0.9))
    masks = {"none": None,
             "tail": torch.tensor([1, 0, 1, 1, 0, 1, 1, 0],
                                  dtype=torch.float32),
             "rank1_masked": torch.tensor([1, 1, 0, 1, 0, 0, 0, 0],
                                          dtype=torch.float32)}
    return {"x": torch.from_numpy(x.astype(np.float32)),
            "ct": torch.from_numpy(rng.normal(size=x.shape)
                                   .astype(np.float32)),
            "bn": bn.state_dict(), "masks": masks}


def _clf_inputs():
    rng = np.random.default_rng(69)
    t = torch.from_numpy
    model = ResNet50(2, stage_sizes=(1, 1, 1, 1),
                     generator=torch.Generator().manual_seed(70))
    return {"real": t(rng.integers(0, 255, (N, SIZE, SIZE, 3), np.uint8)),
            "real_labels": t((np.arange(N) % 2).astype(np.int32)),
            "synth": t(rng.integers(0, 255, (5, SIZE, SIZE, 3), np.uint8)),
            "synth_labels": torch.ones(5, dtype=torch.int32),
            "model": model.state_dict(), "stages": (1, 1, 1, 1),
            "idx": t(rng.integers(0, N, (B,))),
            "draws": [{"use_synth": t(rng.random(B) < 0.5),
                       "synth_pick": t(rng.integers(0, 5, (B,))),
                       "flip": t(rng.random(B) < 0.5)}
                      for _ in range(STEPS)]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 emulated devices")
    mesh = create_mesh(devices=devs[:2])
    rng = np.random.default_rng(71)
    images = rng.integers(0, 255, (N, SIZE, SIZE, 3), np.uint8)
    labels = (np.arange(N) % 2).astype(np.int32)
    chunk = rng.permutation(N)[:K * B].reshape(K, B).astype(np.int32)
    jax_side = _jax_runs(mesh, images, labels, chunk, jax.random.key(72))
    gan_in = {"latent": LATENT, "fm": FM, "size": SIZE, "lr": LR,
              "critic_iters": 2, "images": torch.from_numpy(images),
              "labels": torch.from_numpy(labels.astype(np.int64)),
              "nets": {k: v["init"] for k, v in jax_side.items()},
              "draws": {k: v["draws"] for k, v in jax_side.items()},
              "vgg": jax_side["cgan"]["vgg"]}
    bn_in = _bn_inputs()
    ranks = run_cases({
        "bn:c10": bn_in,
        "zero1": {**gan_in, "idx": torch.from_numpy(chunk[0].astype(
            np.int64)), "steps": STEPS, "min": MIN, "clf": _clf_inputs(),
            "clf_runs": CLF_RUNS},
        "kstep": {**gan_in, "chunk": torch.from_numpy(chunk.astype(
            np.int64))}}, tmp_path_factory.mktemp("dist_zero1"))
    return {"jax": jax_side, "bn": (bn_in, ranks["bn:c10"]),
            "zero1": ranks["zero1"], "kstep": ranks["kstep"]}


def _reference_bn(bn_in, mask):
    """One process's BN over the whole batch in float64: ``F.batch_norm``
    on the valid rows for their outputs and the running statistics, the
    same statistics applied to every row for the others and the
    gradients."""
    sd = {k: v.double() for k, v in bn_in["bn"].items()
          if v.is_floating_point()}
    x = bn_in["x"].double().requires_grad_(True)
    scale = sd["weight"].clone().requires_grad_(True)
    bias = sd["bias"].clone().requires_grad_(True)
    valid = torch.ones(x.shape[0], dtype=torch.bool) if mask is None \
        else mask > 0
    xv = x[valid].permute(0, 3, 1, 2)  # NCHW for F.batch_norm
    rm, rv = sd["running_mean"].clone(), sd["running_var"].clone()
    yv = F.batch_norm(xv, rm, rv, scale, bias, training=True,
                      momentum=0.1, eps=1e-5)
    var, mean = torch.var_mean(x[valid], dim=(0, 1, 2), unbiased=False)
    y = (x - mean) / torch.sqrt(var + 1e-5) * scale + bias
    # F.batch_norm's x * a + b form cancels to ~1e-12 at these means
    torch.testing.assert_close(y[valid], yv.permute(0, 2, 3, 1), rtol=1e-9,
                               atol=1e-9)
    (y * bn_in["ct"].double()).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dscale": scale.grad,
            "dbias": bias.grad, "mean": rm, "var": rv}


def _rel_close(got, want, what):
    """Within 1e-6 of ``want``'s largest magnitude."""
    got, want = got.double(), want.double()
    err = float((got - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max()), (what, err)


@pytest.mark.parametrize("mask", ["none", "tail", "rank1_masked"])
def test_c10_bn_across_ranks_equals_one_process(runs, mask):
    bn_in, ranks = runs["bn"]
    want = _reference_bn(bn_in, bn_in["masks"][mask])
    got = [r[mask] for r in ranks]
    _rel_close(torch.cat([g["y"] for g in got]), want["y"], "y")
    _rel_close(torch.cat([g["dx"] for g in got]), want["dx"], "dx")
    _rel_close(got[0]["dscale"] + got[1]["dscale"], want["dscale"], "dscale")
    _rel_close(got[0]["dbias"] + got[1]["dbias"], want["dbias"], "dbias")
    for g in got:
        _rel_close(g["mean"], want["mean"], "running mean")
        _rel_close(g["var"], want["var"], "running var")
    assert torch.equal(got[0]["mean"], got[1]["mean"])
    assert torch.equal(got[0]["var"], got[1]["var"])


def test_c10_one_pass_variance_fails_these_channels(runs):
    """The one-pass variance ``s2/n - mean^2`` in f32 on the same rows:
    what the ranks combined before, off by far more than 1e-6."""
    bn_in, _ = runs["bn"]
    x = bn_in["x"]
    mean = x.mean(dim=(0, 1, 2))
    var = x.square().mean(dim=(0, 1, 2)) - mean.square()
    want = x.double().var(dim=(0, 1, 2), unbiased=False)
    assert float(((var.double() - want) / want).abs().max()) > 1e-2


NAMES = [*KINDS, *CLF_RUNS]


@pytest.mark.parametrize("name", NAMES)
def test_zero1_parameters_bitwise_equal_replicated_adam(runs, name):
    for r in runs["zero1"]:
        plain, zero = r[f"{name}_plain"]["params"], r[f"{name}_zero"]["params"]
        assert plain.keys() == zero.keys()
        moved = 0
        for k, v in plain.items():
            assert torch.equal(zero[k], v), (name, k)
            moved += int(v.is_floating_point())
        assert moved
    a, b = (r[f"{name}_zero"]["params"] for r in runs["zero1"])
    assert all(torch.equal(v, b[k]) for k, v in a.items())


@pytest.mark.parametrize("name", NAMES)
def test_zero1_rank_keeps_half_of_each_wide_moment(runs, name):
    wide = narrow = 0
    for r in runs["zero1"]:
        plain = r[f"{name}_plain"]["moments"]
        zero = r[f"{name}_zero"]["moments"]
        assert plain.keys() == zero.keys() and plain
        for k, n in plain.items():
            if zero[k] == n:
                narrow += 1
            else:
                assert 2 * zero[k] == n, (name, k, zero[k], n)
                wide += 1
    assert wide and narrow, (name, wide, narrow)


def test_zero1_whole_state_dict_resumes_bitwise(runs):
    for r in runs["zero1"]:
        a, b = r["dcgan_zero"]["params"], r["dcgan_resumed"]["params"]
        assert all(torch.equal(v, b[k]) for k, v in a.items())


@pytest.mark.parametrize("kind", KINDS)
def test_k2_matches_k1_on_two_ranks(runs, kind):
    for r in runs["kstep"]:
        one, two = r[f"{kind}_k1"], r[f"{kind}_k{K}"]
        np.testing.assert_allclose(two["metrics"].numpy(),
                                   one["metrics"].numpy(), **LOOP_TOL)
        for k, v in one["params"].items():
            torch.testing.assert_close(two["params"][k].double(),
                                       v.double(), **LOOP_TOL, msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_k2_on_two_ranks_matches_the_jax_k_step_program(runs, kind):
    want = runs["jax"][kind]
    for r in runs["kstep"]:
        got = r[f"{kind}_k{K}"]
        np.testing.assert_allclose(got["metrics"].numpy(), want["metrics"],
                                   **LOOP_TOL)
        params = got["params"]
        split = ({k[2:]: v for k, v in params.items() if k[:2] == "g."},
                 {k[2:]: v for k, v in params.items() if k[:2] == "d."})
        # Adam steps per parameter: 2 of each net, 2 critic updates a step
        if kind == "cgan":
            # every element within 3 lr an Adam step; not the count of
            # elements at PARAMS_TOL: at the CGAN's reference init the
            # JAX step's one-pass BN variance (ROADMAP C10, which the
            # ranks' Chan combine fixes) moves 0.3 % of G's conv weights
            # by up to 2 lr, the coordinates whose gradient is rounding
            # noise
            for g, w in zip(split, want["final"]):
                for k, v in w.items():
                    np.testing.assert_allclose(
                        g[k].double().numpy(), v.double().numpy(), rtol=0,
                        atol=3 * LR * K, err_msg=k)
        else:
            wgan_close(split, want["final"], PARAMS_TOL["atol"],
                       PARAMS_TOL["rtol"], 2 * K if kind == "wgan" else K)
