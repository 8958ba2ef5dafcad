"""xgan_torch's WGAN-GP step across two gloo ranks on the CPU
(``tests/torch_port_dist_worker.py``, two processes) against the JAX
package's DP step on a 2-device CPU mesh and against one rank, and the
double backward of the cross-rank all-reduce under it.

- Two WGAN-GP steps (``critic_iters`` 2; a full batch of 16, then a
  wrap-padded tail of 5 valid rows, so that rank 1's rows are all
  masked) from the same weights with the JAX step's own draws, with the
  replicated store and with ``--shard-store``'s, and one step at
  ``grad_accum=2`` (each rank holding its 4 rows of each microbatch of
  8): the losses of ``make_wgan_step(batch_sharding=...)`` on
  ``create_mesh(devices=jax.devices()[:2])`` at tests/test_sharding.py's
  tolerances (rtol 2e-4, atol 2e-5); its parameters and BN buffers at
  that file's parameter tolerances (rtol 2e-3, atol 2e-5) but for at
  most 1 in 1000 elements, which stay within 2 lr an Adam step (Adam
  moves a coordinate whose gradient is reduction-order noise by up to lr
  either way). The same steps of the port on one rank (its BN on the
  sums path the ranks take, by an all-ones mask): the losses within
  1e-5, the parameters within 1e-5 but for the same 1 in 1000; both
  ranks' parameters and BN buffers bitwise equal after the steps.
- The penalty's double backward through the cross-rank all-reduce
  (``all_reduce_sum``, whose backward must itself be a differentiable
  all-reduce): a penalty on per-row input-gradient norms through a
  BN-like function whose mean and variance sum over the ranks, its
  gradient in a weight summed over two ranks, equals one process over
  the concatenated batch in float64 within 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_wgan_step import _draws, _reference_init
from tests.torch_port_dist_worker import penalty, run_cases
from xgan.models import wgan as jax_wgan
from xgan.parallel import create_mesh
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan.train.wgan import make_wgan_step
from xgan_torch.models.convert import (critic_state_dict_from_jax,
                                       generator_state_dict_from_jax)
from xgan_torch.models.wgan import Critic, Generator
from xgan_torch.train.common import adam
from xgan_torch.train.wgan import wgan_step

torch.set_num_threads(1)

LATENT, FM, SIZE, B, LR, N = 8, 8, 32, 16, 2e-4, 24
N_CRITIC, LAMBDA = 2, 10.0
METRICS_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_sharding.py:51
PARAMS_TOL = dict(rtol=2e-3, atol=2e-5)   # tests/test_sharding.py:55
TAIL_VALID = 5  # rank 1's 8 rows of the tail are all padding
# run -> (the shard-store flag, grad_accum, the steps it takes)
RUNS = {"replicated": (False, 1, 2), "sharded": (True, 1, 2),
        "accum": (False, 2, 1)}


def _jax_states(mesh, g_vars, c_vars, g_tx, c_tx):
    return (mesh.replicate(ModelState(params=g_vars[0], batch_stats=g_vars[1],
                                      opt_state=g_tx.init(g_vars[0]))),
            mesh.replicate(ModelState(params=c_vars[0], batch_stats=c_vars[1],
                                      opt_state=c_tx.init(c_vars[0]))))


def _state_dicts(g_state, c_state):
    return (generator_state_dict_from_jax(*jax.device_get(
                (g_state.params, g_state.batch_stats))),
            critic_state_dict_from_jax(*jax.device_get(
                (c_state.params, c_state.batch_stats))))


@pytest.fixture(scope="module")
def wgan_run(tmp_path_factory):
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 emulated devices")
    mesh = create_mesh(devices=devs[:2])
    g_model = jax_wgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                 image_size=SIZE)
    c_model = jax_wgan.Critic(feature_maps=FM, image_size=SIZE)
    g_tx, c_tx = jax_adam(LR, 0.5, beta2=0.9), jax_adam(LR, 0.5, beta2=0.9)
    g_vars = _reference_init(g_model, jnp.zeros((2, LATENT)), 20)
    c_vars = _reference_init(c_model, jnp.zeros((2, SIZE, SIZE, 3)), 21)
    g0 = generator_state_dict_from_jax(*g_vars)
    c0 = critic_state_dict_from_jax(*c_vars)
    images = np.random.default_rng(22).integers(0, 255, (N, SIZE, SIZE, 3),
                                                np.uint8)
    order = np.random.default_rng(23).permutation(N).astype(np.int32)
    tail = np.resize(order, 2 * B)[B:]
    steps = [(order[:B], None, jax.random.key(30)),
             (tail, (np.arange(B) < TAIL_VALID).astype(np.float32),
              jax.random.key(31))]
    port_steps = [{"idx": torch.from_numpy(idx.astype(np.int64)),
                   "mask": None if mask is None else torch.from_numpy(mask),
                   "draws": _draws(key, B)} for idx, mask, key in steps]

    want = {}
    for name, (_, accum, n) in RUNS.items():
        if name == "sharded":
            continue
        step = make_wgan_step(g_model, c_model, g_tx, c_tx,
                              latent_dim=LATENT, critic_iters=N_CRITIC,
                              lambda_gp=LAMBDA,
                              batch_sharding=mesh.batch_sharding(4),
                              donate=False, grad_accum=accum)
        g_state, c_state = _jax_states(mesh, g_vars, c_vars, g_tx, c_tx)
        losses = []
        for idx, mask, key in steps[:n]:
            g_state, c_state, d_l, g_l = step(
                g_state, c_state, mesh.replicate(jnp.asarray(images)),
                jnp.asarray(idx), key,
                mask=None if mask is None else jnp.asarray(mask))
            losses.append(np.concatenate([np.asarray(d_l).reshape(-1),
                                          [float(g_l)]]))
        want[name] = (np.stack(losses), *_state_dicts(g_state, c_state))
    want["sharded"] = want["replicated"]

    # the one-rank reference passes an all-ones mask: its BN then takes
    # the sums path (one-pass variance) the ranks take
    one, ones = {}, torch.ones(B)
    for name, (_, accum, n) in RUNS.items():
        g, c = Generator(LATENT, 3, FM, SIZE), Critic(3, FM, SIZE)
        g.load_state_dict(g0)
        c.load_state_dict(c0)
        opt_g = adam(g.parameters(), LR, 0.5, 0.9)
        opt_c = adam(c.parameters(), LR, 0.5, 0.9)
        losses = [wgan_step(g, c, opt_g, opt_c, torch.from_numpy(images),
                            s["idx"], latent_dim=LATENT,
                            critic_iters=N_CRITIC, lambda_gp=LAMBDA,
                            mask=ones if s["mask"] is None else s["mask"],
                            grad_accum=accum,
                            **s["draws"]).numpy()
                  for s in port_steps[:n]]
        one[name] = (np.stack(losses), g.state_dict(), c.state_dict())

    rng = np.random.default_rng(24)
    pen_in = {"x": torch.from_numpy(rng.normal(size=(8, 5)) * 2 + 0.3),
              "w": torch.from_numpy(rng.normal(size=(5, 5))),
              "v": torch.from_numpy(rng.normal(size=(5,)))}
    ranks = run_cases({
        "wgan": {"latent": LATENT, "fm": FM, "size": SIZE, "lr": LR,
                 "critic_iters": N_CRITIC, "lambda_gp": LAMBDA,
                 "g": g0, "c": c0, "images": torch.from_numpy(images),
                 "steps": port_steps,
                 "runs": {k: v[:2] for k, v in RUNS.items()},
                 "n_steps": {k: v[2] for k, v in RUNS.items()}},
        "penalty": pen_in}, tmp_path_factory.mktemp("dist_wgan"))
    return {"want": want, "one": one, "ranks": ranks["wgan"],
            "penalty": (pen_in, ranks["penalty"])}


@pytest.mark.parametrize("run", list(RUNS))
def test_two_ranks_match_the_jax_mesh_step(wgan_run, run):
    want_l, want_g, want_c = wgan_run["want"][run]
    adam_steps = want_l.shape[0] * N_CRITIC
    for r in wgan_run["ranks"]:
        np.testing.assert_allclose(r[run]["losses"].numpy(), want_l,
                                   **METRICS_TOL)
        _params_close((r[run]["g"], r[run]["c"]), (want_g, want_c),
                      PARAMS_TOL["atol"], PARAMS_TOL["rtol"], adam_steps)


@pytest.mark.parametrize("run", list(RUNS))
def test_two_ranks_match_one_rank(wgan_run, run):
    one_l, one_g, one_c = wgan_run["one"][run]
    r0 = wgan_run["ranks"][0][run]
    np.testing.assert_allclose(r0["losses"].numpy(), one_l, rtol=0,
                               atol=1e-5)
    _params_close((r0["g"], r0["c"]), (one_g, one_c), 1e-5, 0.0,
                  one_l.shape[0] * N_CRITIC)


def _params_close(got, want, atol, rtol, adam_steps):
    """Every element within 2 lr an Adam step, and all but 1 in 1000
    within ``atol + rtol |want|``: Adam's first steps move a coordinate
    whose gradient is reduction-order noise by up to lr either way."""
    outside = total = 0
    for g, w in zip(got, want):
        for k, v in w.items():
            a, b = g[k].double().numpy(), v.double().numpy()
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=2 * LR * adam_steps, err_msg=k)
            outside += int(np.sum(np.abs(a - b) > atol + rtol * np.abs(b)))
            total += a.size
    assert outside <= total // 1000, (outside, total)


@pytest.mark.parametrize("run", list(RUNS))
def test_ranks_stay_bitwise_equal(wgan_run, run):
    r0, r1 = (r[run] for r in wgan_run["ranks"])
    assert torch.equal(r0["losses"], r1["losses"])
    for net in ("g", "c"):
        assert r0[net].keys() == r1[net].keys()
        for k, v in r0[net].items():
            assert torch.equal(v, r1[net][k]), (net, k)


def test_penalty_double_backward_across_ranks_equals_one_process(wgan_run):
    pen_in, ranks = wgan_run["penalty"]
    w = pen_in["w"].clone().requires_grad_(True)
    pen = penalty(pen_in["x"], w, pen_in["v"], pen_in["x"].shape[0],
                  lambda t: t)
    pen.backward()
    got = ranks[0]["dw"] + ranks[1]["dw"]
    assert got.dtype == torch.float64
    torch.testing.assert_close(ranks[0]["pen"] + ranks[1]["pen"],
                               pen.detach(), rtol=0, atol=1e-10)
    torch.testing.assert_close(got, w.grad, rtol=0, atol=1e-10)
