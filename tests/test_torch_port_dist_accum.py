"""``--grad-accum`` and ``--remat`` across two gloo ranks on the CPU
(``tests/torch_port_dist_worker.py``): each rank holds its share of every
microbatch, as the JAX package row-shards each microbatch over ``data``,
against the JAX package's steps on a 2-device CPU mesh and against one
rank.

- DCGAN at ``grad_accum=2``: a full batch of 16 and a wrap-padded tail of
  5 valid rows (its second microbatch all padding, skipped on both
  ranks), and a batch of 6 whose microbatches of 3 rows split 1 and 2
  over the ranks (the JAX step computes the one-device function there
  too). Against ``make_dcgan_step(batch_sharding=..., grad_accum=2)``:
  the metrics at tests/test_sharding.py's tolerances (rtol 2e-4, atol
  2e-5), the parameters and BN buffers within 2 lr an Adam step and at
  its parameter tolerances (rtol 2e-3, atol 2e-5) but for 1 in 1000
  elements. Against one rank (an all-ones mask puts its BN on the ranks'
  sums path): the metrics within 1e-5, the parameters within 1e-5 but
  for the same 1 in 1000. Both ranks bitwise equal.
- The classifier (``--unfreeze``, mix mode, B = 8) at ``grad_accum=2``
  against ``make_train_step(batch_sharding=..., grad_accum=2,
  use_pallas_gather=True, pallas_interpret=True)``: the mean loss within
  1e-5 relative, ``fc`` and the BN running statistics within 1e-4
  (tests/test_torch_port_dist_classifier.py's tolerances), the
  per-sample losses within 5e-5 relative (BN over microbatches of 4 rows:
  the JAX step itself on one device and on two differs by 1.7e-5 there);
  each step one gather of the rank's rows (``mixed_gather_ranks``).
- The classifier under ``--remat`` at each scope (block, stage, nested)
  across the ranks against the same step without remat: the per-sample
  outputs and the model (weights and BN running statistics, which
  advance once a step) within 1e-6; one gather a step; both ranks
  bitwise equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_classifier import _mix_draws, _stores
from tests.test_torch_port_resnet import (_running_stats, jax_resnet,
                                         port_resnet)
from tests.torch_port_dist_worker import run_cases
from xgan.models import dcgan as jax_dcgan
from xgan.parallel import create_mesh
from xgan.train.classifier import classifier_optimizer as jax_optimizer
from xgan.train.classifier import make_train_step
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan.train.common import create_state
from xgan.train.gan import make_dcgan_step
from xgan_torch.models.convert import (discriminator_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.gan import dcgan_step

torch.set_num_threads(1)

LATENT, FM, SIZE, LR, N, A = 8, 8, 32, 2e-4, 24, 2
METRICS_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_sharding.py:51
PARAMS_TOL = dict(rtol=2e-3, atol=2e-5)   # tests/test_sharding.py:55
# DCGAN run -> its steps' (batch, valid rows or None for all)
GAN_RUNS = {"even": ((16, None), (16, 5)), "uneven": ((6, None),)}
CLS_B, NS, RATIO, CLS_LR, STAGES = 8, 5, 0.5, 1e-3, (1, 1, 1, 1)
# classifier run -> (mode, sharded store, masked, grad_accum, remat scope)
CLS_RUNS = {"plain": ("mix", False, False, 1, None),
            "accum": ("mix", False, False, A, None),
            **{f"remat_{s}": ("mix", False, False, 1, s)
               for s in ("block", "stage", "nested")}}


def _mesh():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 emulated devices")
    return create_mesh(devices=devs[:2])


def _gan_draws(key, b):
    k_flip, k_noise = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5,
                                                           (b,)))),
            torch.from_numpy(np.array(jax.random.normal(k_noise,
                                                        (b, LATENT)))))


def _params_close(got, want, atol, rtol, adam_steps):
    """Every element within 2 lr an Adam step, and all but 1 in 1000
    within ``atol + rtol |want|``: Adam moves a coordinate whose gradient
    is reduction-order noise by up to lr either way."""
    outside = total = 0
    for g, w in zip(got, want):
        for k, v in w.items():
            a, b = g[k].double().numpy(), v.double().numpy()
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2 * LR * adam_steps, err_msg=k)
            outside += int(np.sum(np.abs(a - b) > atol + rtol * np.abs(b)))
            total += a.size
    assert outside <= total // 1000, (outside, total)


@pytest.fixture(scope="module")
def accum_run(tmp_path_factory):
    mesh = _mesh()
    rep = mesh.replicate
    # -- DCGAN
    g_model = jax_dcgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                  image_size=SIZE)
    d_model = jax_dcgan.Discriminator(feature_maps=FM, image_size=SIZE)
    g_tx, d_tx = jax_adam(LR, 0.5), jax_adam(LR, 0.5)
    key = jax.random.key(50)
    g_init = create_state(g_model, g_tx, key, jnp.zeros((2, LATENT)),
                          train=False)
    d_init = create_state(d_model, d_tx, key, jnp.zeros((2, SIZE, SIZE, 3)),
                          train=False)
    g0 = generator_state_dict_from_jax(*jax.device_get(
        (g_init.params, g_init.batch_stats)))
    d0 = discriminator_state_dict_from_jax(*jax.device_get(
        (d_init.params, d_init.batch_stats)))
    images = np.random.default_rng(51).integers(0, 255, (N, SIZE, SIZE, 3),
                                                np.uint8)
    order = np.resize(np.random.default_rng(52).permutation(N), 64)
    step = make_dcgan_step(g_model, d_model, g_tx, d_tx, latent_dim=LATENT,
                           batch_sharding=mesh.batch_sharding(4),
                           donate=False, grad_accum=A)
    gan_want, gan_one, gan_inputs = {}, {}, {}
    for name, steps in GAN_RUNS.items():
        g_state, d_state = rep(g_init), rep(d_init)
        g, d = Generator(LATENT, 3, FM, SIZE), Discriminator(3, FM, SIZE)
        g.load_state_dict(g0)
        d.load_state_dict(d0)
        opt_g, opt_d = adam(g.parameters(), LR, 0.5), adam(d.parameters(),
                                                           LR, 0.5)
        want, one, port_steps, at = [], [], [], 0
        for t, (b, valid) in enumerate(steps):
            idx = order[at:at + b].astype(np.int32)
            at += b
            mask = None if valid is None else \
                (np.arange(b) < valid).astype(np.float32)
            k = jax.random.key(60 + t)
            g_state, d_state, m = step(
                g_state, d_state, rep(jnp.asarray(images)), jnp.asarray(idx),
                k, mask=None if mask is None else jnp.asarray(mask))
            want.append(np.asarray(m))
            flip, noise = _gan_draws(k, b)
            s = {"idx": torch.from_numpy(idx.astype(np.int64)),
                 "mask": None if mask is None else torch.from_numpy(mask),
                 "flip": flip, "noise": noise, "grad_accum": A}
            port_steps.append(s)
            one.append(dcgan_step(
                g, d, opt_g, opt_d, torch.from_numpy(images), s["idx"],
                latent_dim=LATENT, noise=noise, flip=flip, grad_accum=A,
                mask=torch.ones(b) if mask is None else s["mask"]).numpy())
        gan_want[name] = (np.stack(want), *(
            f(*jax.device_get((st.params, st.batch_stats)))
            for f, st in ((generator_state_dict_from_jax, g_state),
                          (discriminator_state_dict_from_jax, d_state))))
        gan_one[name] = (np.stack(one), g.state_dict(), d.state_dict())
        gan_inputs[name] = port_steps

    # -- classifier
    fmodel, params, stats = jax_resnet(seed=53)
    real, real_labels, synth, synth_labels = _stores(54)
    idx = np.array([4, 0, 9, 1, 7, 3, 10, 6], np.int32)
    ckey = jax.random.key(55)
    k_mix, k_flip = jax.random.split(ckey)
    use_synth, pick = _mix_draws(k_mix, RATIO, NS)
    flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5,
                                                          (CLS_B,))))
    tx = jax_optimizer(CLS_LR, freeze_base=False)
    cstep = make_train_step(fmodel, tx, mode="mix",
                            batch_sharding=mesh.batch_sharding(4),
                            use_pallas_gather=True, pallas_interpret=True,
                            grad_accum=A)
    new_state, losses, _, _ = cstep(
        rep(ModelState(params=params, batch_stats=stats,
                       opt_state=tx.init(params))),
        rep(jnp.asarray(real)), rep(jnp.asarray(real_labels)),
        rep(jnp.asarray(synth)), rep(jnp.asarray(synth_labels)),
        jnp.asarray(idx), jnp.float32(RATIO), ckey)
    t = torch.from_numpy
    ranks = run_cases({
        "gan": {"latent": LATENT, "fm": FM, "size": SIZE, "lr": LR,
                "g": g0, "d": d0, "images": t(images),
                "steps": gan_inputs["even"], "runs": {"even": False}},
        "classifier": {
            "real": t(real), "real_labels": t(real_labels), "synth": t(synth),
            "synth_labels": t(synth_labels),
            "model": port_resnet(params, stats).state_dict(),
            "stages": STAGES, "lr": CLS_LR, "ratio": RATIO,
            "use_synth": use_synth, "pick": pick, "flip": flip,
            "mask": torch.ones(CLS_B), "idx": t(idx.astype(np.int64)),
            "runs": CLS_RUNS}}, tmp_path_factory.mktemp("dist_accum"))
    # the uneven batch in a group of its own: the gan case runs one list
    # of steps
    uneven = run_cases({"gan": {
        "latent": LATENT, "fm": FM, "size": SIZE, "lr": LR, "g": g0,
        "d": d0, "images": t(images), "steps": gan_inputs["uneven"],
        "runs": {"uneven": False}}}, tmp_path_factory.mktemp("dist_uneven"))
    gan_ranks = [{**a, **b} for a, b in zip(ranks["gan"], uneven["gan"])]
    return {"gan_want": gan_want, "gan_one": gan_one, "gan": gan_ranks,
            "cls_want": (np.asarray(losses), jax.device_get(new_state)),
            "cls": ranks["classifier"]}


@pytest.mark.parametrize("run", list(GAN_RUNS))
def test_dcgan_accum_matches_the_jax_mesh_step(accum_run, run):
    want_m, want_g, want_d = accum_run["gan_want"][run]
    for r in accum_run["gan"]:
        np.testing.assert_allclose(r[run]["metrics"].numpy(), want_m,
                                   **METRICS_TOL)
        _params_close((r[run]["g"], r[run]["d"]), (want_g, want_d),
                      PARAMS_TOL["atol"], PARAMS_TOL["rtol"],
                      want_m.shape[0])


@pytest.mark.parametrize("run", list(GAN_RUNS))
def test_dcgan_accum_matches_one_rank(accum_run, run):
    one_m, one_g, one_d = accum_run["gan_one"][run]
    r0 = accum_run["gan"][0][run]
    np.testing.assert_allclose(r0["metrics"].numpy(), one_m, rtol=0,
                               atol=1e-5)
    _params_close((r0["g"], r0["d"]), (one_g, one_d), 1e-5, 0.0,
                  one_m.shape[0])


@pytest.mark.parametrize("run", list(GAN_RUNS))
def test_dcgan_accum_ranks_stay_bitwise_equal(accum_run, run):
    r0, r1 = (r[run] for r in accum_run["gan"])
    assert torch.equal(r0["metrics"], r1["metrics"])
    for net in ("g", "d"):
        for k, v in r0[net].items():
            assert torch.equal(v, r1[net][k]), (net, k)


def test_classifier_accum_matches_the_jax_mesh_step(accum_run):
    losses, state = accum_run["cls_want"]
    ref = float(losses.mean())
    fc = state.params["fc"]
    for r in (r["accum"] for r in accum_run["cls"]):
        assert r["gathers"] == 1
        got = float(r["losses"].numpy().mean())
        assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
        np.testing.assert_allclose(r["losses"].numpy(), losses, rtol=5e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["model"]["fc.weight"].numpy(),
                                   np.asarray(fc["kernel"]).T, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(r["model"]["fc.bias"].numpy(),
                                   np.asarray(fc["bias"]), rtol=0, atol=1e-4)
        for k, v in _running_stats(state.batch_stats).items():
            np.testing.assert_allclose(r["model"][k].numpy(), v, rtol=0,
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("scope", ["block", "stage", "nested"])
def test_classifier_remat_across_ranks_equals_no_remat(accum_run, scope):
    for r in accum_run["cls"]:
        got, want = r[f"remat_{scope}"], r["plain"]
        assert got["gathers"] == want["gathers"] == 1
        for k in ("losses", "preds", "labels"):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-6)
        for k, v in want["model"].items():
            torch.testing.assert_close(got["model"][k], v, rtol=0,
                                       atol=1e-6, msg=k)
    r0, r1 = (r[f"remat_{scope}"] for r in accum_run["cls"])
    for k, v in r0["model"].items():
        assert torch.equal(v, r1["model"][k]), k
