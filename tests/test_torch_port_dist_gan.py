"""xgan_torch's DCGAN step and BN across two gloo ranks on the CPU
(``tests/torch_port_dist_worker.py``, two processes) against the JAX
package's DP step on a 2-device CPU mesh and against one rank.

- Two DCGAN steps (a full batch, then a wrap-padded tail of 5 valid rows
  of 16, so that rank 1's rows are all masked) from the same weights and
  the JAX step's own flip and noise draws: the metrics of
  ``make_dcgan_step(batch_sharding=...)`` on
  ``create_mesh(devices=jax.devices()[:2])`` at tests/test_sharding.py's
  tolerances (rtol 2e-4, atol 2e-5), with the replicated store and with
  ``--shard-store``'s. Its parameters and BN buffers at that file's
  parameter tolerances (rtol 2e-3, atol 2e-5) but for at most 1 in 1000
  elements, which stay within tests/test_torch_port_gan_step.py's
  cross-package bound of 2 * lr a step: Adam moves a coordinate whose
  gradient is reduction-order noise by up to lr either way (one of D's
  8,192 conv weights moves 1.9 lr apart here). The same steps of the
  port on one rank within 1e-5; both ranks' parameters and BN buffers
  bitwise equal after the steps.
- Cross-rank train BN through ``layers.batch_norm``: each rank's output
  and input gradient equal one rank's over the concatenated batch, the
  ranks' scale and bias gradients summed equal its, and the running
  statistics equal on both ranks, within 1e-6 relative and absolute
  (f32), unmasked, masked, and with rank 1's rows all masked.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tests.torch_port_dist_worker import run_cases
from xgan.models import dcgan as jax_dcgan
from xgan.parallel import create_mesh
from xgan.train.common import adam as jax_adam
from xgan.train.common import create_state
from xgan.train.gan import make_dcgan_step
from xgan_torch.models.convert import (discriminator_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.ops.norm import batch_norm_train
from xgan_torch.train.common import adam
from xgan_torch.train.gan import dcgan_step

torch.set_num_threads(1)

LATENT, FM, SIZE, B, LR, N = 8, 8, 32, 16, 2e-4, 24
METRICS_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_sharding.py:51
PARAMS_TOL = dict(rtol=2e-3, atol=2e-5)   # tests/test_sharding.py:55
TAIL_VALID = 5  # rank 1's 8 rows of the tail are all padding


def _jax_side():
    """(the JAX step on the 2-device mesh, its states, the images, the
    steps' (idx, mask, key))."""
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 emulated devices")
    mesh = create_mesh(devices=devs[:2])
    g_model = jax_dcgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                  image_size=SIZE)
    d_model = jax_dcgan.Discriminator(feature_maps=FM, image_size=SIZE)
    g_tx, d_tx = jax_adam(LR, 0.5), jax_adam(LR, 0.5)
    key = jax.random.key(3)
    g_state = mesh.replicate(create_state(g_model, g_tx, key,
                                          jnp.zeros((2, LATENT)),
                                          train=False))
    d_state = mesh.replicate(create_state(d_model, d_tx, key,
                                          jnp.zeros((2, SIZE, SIZE, 3)),
                                          train=False))
    step = make_dcgan_step(g_model, d_model, g_tx, d_tx, latent_dim=LATENT,
                           batch_sharding=mesh.batch_sharding(4),
                           donate=False)
    images = np.random.default_rng(4).integers(0, 255, (N, SIZE, SIZE, 3),
                                               np.uint8)
    order = np.random.default_rng(5).permutation(N).astype(np.int32)
    tail = np.resize(order, 2 * B)[B:]
    steps = [(order[:B], None, jax.random.key(10)),
             (tail, (np.arange(B) < TAIL_VALID).astype(np.float32),
              jax.random.key(11))]
    return mesh, step, (g_state, d_state), images, steps


def _draws(key):
    """The flip mask and noise the JAX step draws from ``key``."""
    k_flip, k_noise = jax.random.split(key)
    return (torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5,
                                                           (B,)))),
            torch.from_numpy(np.array(jax.random.normal(k_noise,
                                                        (B, LATENT)))))


def _state_dicts(g_state, d_state):
    g = generator_state_dict_from_jax(*jax.device_get(
        (g_state.params, g_state.batch_stats)))
    d = discriminator_state_dict_from_jax(*jax.device_get(
        (d_state.params, d_state.batch_stats)))
    return g, d


@pytest.fixture(scope="module")
def gan_run(tmp_path_factory):
    mesh, step, (g_state, d_state), images, steps = _jax_side()
    g0, d0 = _state_dicts(g_state, d_state)
    port_steps, want = [], []
    for idx, mask, key in steps:
        g_state, d_state, m = step(
            g_state, d_state, mesh.replicate(jnp.asarray(images)),
            jnp.asarray(idx), key,
            mask=None if mask is None else jnp.asarray(mask))
        want.append(np.asarray(m))
        flip, noise = _draws(key)
        port_steps.append({"idx": torch.from_numpy(idx.astype(np.int64)),
                           "mask": None if mask is None
                           else torch.from_numpy(mask),
                           "flip": flip, "noise": noise})
    g1, d1 = _state_dicts(g_state, d_state)

    # the same steps of the port on one rank (no process group), and
    # again with each batch's rows permuted: reduction order alone
    def one_rank(perm):
        g, d = Generator(LATENT, 3, FM, SIZE), Discriminator(3, FM, SIZE)
        g.load_state_dict(g0)
        d.load_state_dict(d0)
        opt_g, opt_d = adam(g.parameters(), LR, 0.5), \
            adam(d.parameters(), LR, 0.5)
        m = [dcgan_step(g, d, opt_g, opt_d, torch.from_numpy(images),
                        s["idx"][perm], latent_dim=LATENT,
                        mask=None if s["mask"] is None else s["mask"][perm],
                        noise=s["noise"][perm], flip=s["flip"][perm]).numpy()
             for s in port_steps]
        return np.stack(m), g.state_dict(), d.state_dict()

    one = one_rank(torch.arange(B))
    floor = [one_rank(torch.from_numpy(np.random.default_rng(s).permutation(
        B))) for s in (0, 1)]

    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(8, 3, 3, 6)).astype(np.float32) * 2 + 0.5)
    bn = nn.BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5, generator=torch.Generator().manual_seed(
            1))
        bn.bias.normal_(0, 0.1, generator=torch.Generator().manual_seed(2))
    masks = {"none": None,
             "tail": torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.float32),
             "rank1_masked": torch.tensor([1, 1, 0, 1, 0, 0, 0, 0],
                                          dtype=torch.float32)}
    bn_in = {"x": x, "ct": torch.from_numpy(np.random.default_rng(7).normal(
        size=x.shape).astype(np.float32)), "bn": bn.state_dict(),
        "masks": masks}

    ranks = run_cases({
        "gan": {"latent": LATENT, "fm": FM, "size": SIZE, "lr": LR,
                "g": g0, "d": d0, "images": torch.from_numpy(images),
                "steps": port_steps,
                "runs": {"replicated": False, "sharded": True}},
        "bn": bn_in}, tmp_path_factory.mktemp("dist_gan"))
    return {"want": (np.stack(want), g1, d1), "one": one, "floor": floor,
            "ranks": ranks["gan"],
            "bn": (bn_in, bn.state_dict(), ranks["bn"])}


@pytest.mark.parametrize("run", ["replicated", "sharded"])
def test_two_ranks_match_the_jax_mesh_step(gan_run, run):
    want_m, want_g, want_d = gan_run["want"]
    steps = want_m.shape[0]
    for r in gan_run["ranks"]:
        np.testing.assert_allclose(r[run]["metrics"].numpy(), want_m,
                                   **METRICS_TOL)
        outside = total = 0
        for got, want in ((r[run]["g"], want_g), (r[run]["d"], want_d)):
            for k, v in want.items():
                a, b = got[k].double().numpy(), v.double().numpy()
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=2 * LR * steps, err_msg=k)
                outside += int(np.sum(np.abs(a - b) > PARAMS_TOL["atol"]
                                      + PARAMS_TOL["rtol"] * np.abs(b)))
                total += a.size
        assert outside <= total // 1000, (outside, total)


@pytest.mark.parametrize("run", ["replicated", "sharded"])
def test_two_ranks_match_one_rank(gan_run, run):
    """The metrics within 1e-5; the parameters and BN buffers within 1e-5
    but for at most 1 in 1000 elements, which stay within 2 * lr a step:
    the floor of ``test_one_rank_floor_of_reduction_order``. The ranks'
    BN moments (Chan's combine, float64) part from the one-rank masked
    step's one-pass variance on one of D's 8,192 conv weights by more
    than 1e-5."""
    one_m, one_g, one_d = gan_run["one"]
    r0 = gan_run["ranks"][0][run]
    steps = one_m.shape[0]
    np.testing.assert_allclose(r0["metrics"].numpy(), one_m, rtol=0,
                               atol=1e-5)
    outside = total = 0
    for got, want in ((r0["g"], one_g), (r0["d"], one_d)):
        for k, v in want.items():
            a, b = got[k].double().numpy(), v.double().numpy()
            np.testing.assert_allclose(a, b, rtol=0, atol=2 * LR * steps,
                                       err_msg=k)
            outside += int(np.sum(np.abs(a - b) > 1e-5))
            total += a.size
    assert outside <= total // 1000, (outside, total)


def test_one_rank_floor_of_reduction_order(gan_run):
    """The one-rank run against itself with each batch's rows permuted:
    a parameter whose gradient is rounding noise parts by more than 1e-5
    (Adam moves it by up to lr either way), so the ranks are held to the
    envelope of ``test_two_ranks_match_one_rank``, not 1e-5 everywhere."""
    _, one_g, one_d = gan_run["one"]
    worst = max(float((got[k].double() - v.double()).abs().max())
                for _, g, d in gan_run["floor"]
                for got, want in ((g, one_g), (d, one_d))
                for k, v in want.items() if v.is_floating_point())
    assert 1e-5 < worst <= 2 * LR * 2, worst


@pytest.mark.parametrize("run", ["replicated", "sharded"])
def test_ranks_stay_bitwise_equal(gan_run, run):
    r0, r1 = (r[run] for r in gan_run["ranks"])
    assert torch.equal(r0["metrics"], r1["metrics"])
    for net in ("g", "d"):
        assert r0[net].keys() == r1[net].keys()
        for k, v in r0[net].items():
            assert torch.equal(v, r1[net][k]), (net, k)


def test_sharded_store_holds_half_the_rows(gan_run):
    # 24 rows over 2 ranks: 12 each, 24 on each replicated rank
    assert [r["sharded"]["local_rows"] for r in gan_run["ranks"]] == [12, 12]
    assert [r["replicated"]["local_rows"] for r in gan_run["ranks"]] \
        == [N, N]


@pytest.mark.parametrize("mask", ["none", "tail", "rank1_masked"])
def test_cross_rank_bn_equals_one_rank_over_the_batch(gan_run, mask):
    bn_in, bn_sd, ranks = gan_run["bn"]
    x = bn_in["x"].clone().requires_grad_(True)
    scale = bn_sd["weight"].clone().requires_grad_(True)
    bias = bn_sd["bias"].clone().requires_grad_(True)
    m = bn_in["masks"][mask]
    y, mean, var = batch_norm_train(x, scale, bias, bn_sd["running_mean"],
                                    bn_sd["running_var"], dim=-1, mask=m)
    (y * bn_in["ct"]).sum().backward()
    got = [r[mask] for r in ranks]
    tol = dict(rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(torch.cat([g["y"] for g in got]), y.detach(),
                               **tol)
    torch.testing.assert_close(torch.cat([g["dx"] for g in got]), x.grad,
                               **tol)
    torch.testing.assert_close(got[0]["dscale"] + got[1]["dscale"],
                               scale.grad, **tol)
    torch.testing.assert_close(got[0]["dbias"] + got[1]["dbias"], bias.grad,
                               **tol)
    for g in got:
        torch.testing.assert_close(g["mean"], mean, **tol)
        torch.testing.assert_close(g["var"], var, **tol)
    assert torch.equal(got[0]["mean"], got[1]["mean"])
    assert torch.equal(got[0]["var"], got[1]["var"])
