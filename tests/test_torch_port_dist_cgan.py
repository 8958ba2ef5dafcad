"""xgan_torch's CGAN step across two gloo ranks on the CPU
(``tests/torch_port_dist_worker.py``, two processes) against the JAX
package's DP step on a 2-device CPU mesh and against one rank. f32,
32 px, widths 8, B = 8 (4 rows a rank), the JAX step's own draws
injected, the weights of tests/torch_port_util.py's ``jax_cgan``.

- ``open``: two steps at epoch 0 (the gate held open), a full batch and
  a wrap-padded tail of 3 valid rows (rank 1's rows all masked).
- ``closed``: the input-magnitude cue probe of tests/test_cgan.py:78-106
  on constant-255 reals, a step at epoch 0, then one at epoch 10 whose
  global D(x) ~ 1 and D(G(z)) < 0.1 close the gate. Each rank's share of
  D(x) is about half of it, under the gate's 0.8: a gate on the shares
  would open on both ranks.
- ``accum``: one step at ``grad_accum=2``, each rank holding its 2 rows
  of each microbatch of 4.

Each against ``make_cgan_step(batch_sharding=...)`` on
``create_mesh(devices=jax.devices()[:2])``: the 7 metrics at
tests/test_sharding.py's tolerances (rtol 2e-4, atol 2e-5); against the
port on one rank (an all-ones mask puts its BN on the ranks' sums path)
within 1e-5 * (1 + |ref|). The parameters and BN buffers against both:
within 3 lr an Adam step, and at tests/test_sharding.py's parameter
tolerances (rtol 2e-3, atol 2e-5) but for 1 in 1000 elements and the
biases right before a BN, whose gradient is 0 in exact arithmetic (Adam
moves a coordinate whose gradient is rounding noise by up to lr either
way, 1.33 lr at its second step). Both ranks end bitwise equal, take the
JAX step's gate decision at every step, and the closed step leaves D's
parameters bitwise as they were.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_cgan_step import _draws
from tests.torch_port_dist_worker import cue_probe_class, run_cases
from tests.torch_port_util import jax_cgan
from xgan.models.vgg import VGG16Features as JaxVGG
from xgan.parallel import create_mesh
from xgan.train.cgan import make_cgan_step
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan_torch.models.cgan import (D_PRE_BN_BIASES, G_PRE_BN_BIASES,
                                    Discriminator, Generator)
from xgan_torch.models.convert import (cgan_discriminator_state_dict_from_jax,
                                       cgan_generator_state_dict_from_jax,
                                       vgg_state_dict_from_jax)
from xgan_torch.models.vgg import VGG16Features
from xgan_torch.train.cgan import GATE_EPOCHS, cgan_step
from xgan_torch.train.common import adam

torch.set_num_threads(1)

LATENT, FM, SIZE, B, LR = 8, 8, 32, 8, 2e-4
METRICS_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_sharding.py:51
PARAMS_TOL = dict(rtol=2e-3, atol=2e-5)   # tests/test_sharding.py:55
TAIL_VALID = 3
# run -> (the cue probe, grad_accum)
RUNS = {"open": (False, 1), "closed": (True, 1), "accum": (False, 2)}


class GatedProbe(nn.Module):
    """The JAX discriminator plus the cue (tests/test_cgan.py:93-106)."""
    base: nn.Module

    @nn.compact
    def __call__(self, x, labels, *, train, features=False, mask=None):
        out = self.base(x, labels, train=train, features=features,
                        mask=mask)
        cue = 20.0 * jnp.mean(nn.relu(jnp.abs(x.astype(jnp.float32)) - 1.5),
                              axis=(1, 2, 3)) - 5.0
        return (out[0] + cue, out[1]) if features else out + cue


def _run_data():
    """Per run: the u8 store, its labels and the steps (idx, mask,
    epoch, key)."""
    rng = np.random.default_rng(40)
    images = rng.integers(0, 255, (12, SIZE, SIZE, 3), np.uint8)
    order = rng.permutation(12).astype(np.int32)
    tail_mask = (np.arange(B) < TAIL_VALID).astype(np.float32)
    flat = np.full((16, SIZE, SIZE, 3), 255, np.uint8)
    labels = {12: (np.arange(12) % 2).astype(np.int32),
              16: (np.arange(16) % 2).astype(np.int32)}
    return {
        "open": (images, labels[12], [
            (order[:B], None, 0, jax.random.key(41)),
            (np.resize(order, 2 * B)[B:], tail_mask, 0,
             jax.random.key(42))]),
        "closed": (flat, labels[16], [
            (np.arange(B, dtype=np.int32), None, 0, jax.random.key(43)),
            (np.arange(B, dtype=np.int32) + B, None, 10,
             jax.random.key(44))]),
        "accum": (images, labels[12], [
            (order[:B], None, 0, jax.random.key(45))])}


def _gate(m, epoch) -> bool:
    return bool(m[2] < 0.8 or m[3] > 0.2 or epoch < GATE_EPOCHS)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.max(np.abs(got - want) / (1 + np.abs(want)))


def _params_close(got, want, adam_steps):
    """(G, D) state dicts: every element within 3 lr an Adam step, and
    all but 1 in 1000 of those that are not a bias right before a BN at
    ``PARAMS_TOL``. Adam moves a coordinate whose gradient is rounding
    noise by up to lr either way at its first step and by up to 1.33 lr
    at its second (bias-corrected, beta1 0.5); a pre-BN bias has a zero
    gradient in exact arithmetic, so each of its moves is such noise
    (tests/test_torch_port_cgan_step.py's ``_bn_stats_close``)."""
    outside = total = 0
    for g, w, free in zip(got, want, (G_PRE_BN_BIASES, D_PRE_BN_BIASES)):
        for k, v in w.items():
            a, b = g[k].double().numpy(), v.double().numpy()
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=3 * LR * adam_steps, err_msg=k)
            if k not in free:
                outside += int(np.sum(np.abs(a - b) > PARAMS_TOL["atol"]
                                      + PARAMS_TOL["rtol"] * np.abs(b)))
                total += a.size
    assert outside <= total // 1000, (outside, total)


@pytest.fixture(scope="module")
def cgan_run(tmp_path_factory):
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 emulated devices")
    mesh = create_mesh(devices=devs[:2])
    g_model, d_model, g_vars, d_vars = jax_cgan(LATENT, FM, SIZE, seed=46)
    vgg_model = JaxVGG()
    vgg_params = jax.device_get(vgg_model.init(
        jax.random.key(47), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    g_tx, d_tx = jax_adam(LR, 0.5), jax_adam(LR, 0.5)
    g0 = cgan_generator_state_dict_from_jax(*g_vars)
    d0 = cgan_discriminator_state_dict_from_jax(*d_vars)
    vgg0 = vgg_state_dict_from_jax(vgg_params)
    data = _run_data()

    want, one, port_data = {}, {}, {}
    for name, (probe, accum) in RUNS.items():
        images, labels, steps = data[name]
        dm = GatedProbe(base=d_model) if probe else d_model
        wrap = (lambda t: {"base": t}) if probe else (lambda t: t)
        step = make_cgan_step(g_model, dm, vgg_model, g_tx, d_tx,
                              latent_dim=LATENT,
                              batch_sharding=mesh.batch_sharding(4),
                              donate=False, grad_accum=accum)
        g_state = mesh.replicate(ModelState(
            params=g_vars[0], batch_stats=g_vars[1],
            opt_state=g_tx.init(g_vars[0])))
        d_params = wrap(d_vars[0])
        d_state = mesh.replicate(ModelState(
            params=d_params, batch_stats=wrap(d_vars[1]),
            opt_state=d_tx.init(d_params)))
        metrics = []
        for idx, mask, epoch, key in steps:
            g_state, d_state, m = step(
                g_state, d_state, mesh.replicate(vgg_params),
                mesh.replicate(jnp.asarray(images)),
                mesh.replicate(jnp.asarray(labels)), jnp.asarray(idx),
                jnp.int32(epoch), key,
                mask=None if mask is None else jnp.asarray(mask))
            metrics.append(np.asarray(m))
        unwrap = (lambda t: t["base"]) if probe else (lambda t: t)
        g_p, g_s, d_p, d_s = jax.device_get(
            (g_state.params, g_state.batch_stats, d_state.params,
             d_state.batch_stats))
        want[name] = (np.stack(metrics),
                      cgan_generator_state_dict_from_jax(g_p, g_s),
                      cgan_discriminator_state_dict_from_jax(unwrap(d_p),
                                                             unwrap(d_s)))

        port_steps = [{"idx": torch.from_numpy(idx.astype(np.int64)),
                       "mask": None if mask is None
                       else torch.from_numpy(mask),
                       "epoch": epoch, "draws": _draws(key, B)}
                      for idx, mask, epoch, key in steps]
        port_data[name] = {"images": torch.from_numpy(images),
                           "labels": torch.from_numpy(labels),
                           "steps": port_steps}

        # one rank; an all-ones mask puts its BN on the sums path
        g = Generator(LATENT, 2, 3, FM, SIZE)
        d = (cue_probe_class() if probe else Discriminator)(2, 3, FM, SIZE)
        vgg = VGG16Features()
        g.load_state_dict(g0)
        d.load_state_dict(d0)
        vgg.load_state_dict(vgg0)
        opt_g, opt_d = adam(g.parameters(), LR, 0.5), adam(d.parameters(),
                                                           LR, 0.5)
        ms = [cgan_step(g, d, vgg, opt_g, opt_d, torch.from_numpy(images),
                        torch.from_numpy(labels.astype(np.int64)), s["idx"],
                        s["epoch"], latent_dim=LATENT,
                        mask=torch.ones(B) if s["mask"] is None
                        else s["mask"], grad_accum=accum,
                        **s["draws"]).numpy()
              for s in port_steps]
        one[name] = (np.stack(ms), g.state_dict(), d.state_dict())

    ranks = run_cases({"cgan": {
        "latent": LATENT, "fm": FM, "size": SIZE, "lr": LR, "g": g0,
        "d": d0, "vgg": vgg0, "runs": RUNS, "data": port_data}},
        tmp_path_factory.mktemp("dist_cgan"))["cgan"]
    return {"want": want, "one": one, "ranks": ranks, "data": data}


@pytest.mark.parametrize("run", list(RUNS))
def test_two_ranks_match_the_jax_mesh_step(cgan_run, run):
    want_m, want_g, want_d = cgan_run["want"][run]
    for r in cgan_run["ranks"]:
        np.testing.assert_allclose(r[run]["metrics"].numpy(), want_m,
                                   **METRICS_TOL)
        _params_close((r[run]["g"], r[run]["d"]), (want_g, want_d),
                      want_m.shape[0])


@pytest.mark.parametrize("run", list(RUNS))
def test_two_ranks_match_one_rank(cgan_run, run):
    one_m, one_g, one_d = cgan_run["one"][run]
    r0 = cgan_run["ranks"][0][run]
    assert _rel(r0["metrics"].numpy(), one_m) <= 1e-5
    _params_close((r0["g"], r0["d"]), (one_g, one_d), one_m.shape[0])


@pytest.mark.parametrize("run", list(RUNS))
def test_ranks_stay_bitwise_equal(cgan_run, run):
    r0, r1 = (r[run] for r in cgan_run["ranks"])
    assert torch.equal(r0["metrics"], r1["metrics"])
    for net in ("g", "d"):
        for k, v in r0[net].items():
            assert torch.equal(v, r1[net][k]), (net, k)


@pytest.mark.parametrize("run", ["open", "closed"])
def test_gate_decision_is_the_jax_steps_on_both_ranks(cgan_run, run):
    want_m = cgan_run["want"][run][0]
    epochs = [s[2] for s in cgan_run["data"][run][2]]
    want = [_gate(m, e) for m, e in zip(want_m, epochs)]
    assert want == ([True, True] if run == "open" else [True, False])
    names = [n for n, p in Discriminator(2, 3, FM, SIZE).named_parameters()]
    for r in cgan_run["ranks"]:
        got = [_gate(m, e) for m, e in zip(r[run]["metrics"].numpy(),
                                           epochs)]
        assert got == want
        if run == "closed":
            m = r[run]["metrics"].numpy()[1]
            assert m[2] > 0.9 and m[3] < 0.1, m
            before, after = r[run]["d_steps"]
            for k in names:  # parameters untouched, BN statistics moved
                assert torch.equal(after[k], before[k]), k
            assert any(not torch.equal(after[k], before[k])
                       for k in after if "running" in k)
