"""xgan_torch's tensor parallelism (``--model-parallel 2``) for the
WGAN-GP and CGAN steps on four gloo ranks on the CPU, laid out as the JAX
package's ``(data, model)`` mesh (data 2 x model 2;
``tests/torch_port_dist_worker.py``'s ``tp_gans`` case, one launch),
against the JAX package's ``(data=4, model=2)`` TP runs on the 8 emulated
devices (placed by ``xgan.parallel.tp.shard_over_model`` at ``MIN_F`` =
64, ``tests/test_tp.py``'s width) and against the port's one process.

- Two WGAN-GP steps (fg = fd = 32, latent 8, 32 px, B = 16, 2 critic
  updates, λ = 10; the JAX step's own draws injected): at MIN_F 64 the
  rule slices G's first four ConvTs and BNs and the critic's last three
  convs and BNs. Two CGAN steps (nf 32, a random VGG16, the gate open at
  epoch 0): the rule slices G's ``fc.bias`` (not its weight: I = 8), BN
  ``main.0``, the 3x3 convs ``main.3`` and ``main.7`` and their BNs, and
  D's ``main.5``, ``main.8`` and ``main.11`` with their biases and BNs.
  Against the JAX TP run, the losses or metrics and the whole states at
  ``tests/test_tp.py``'s post-update tolerances (rtol 5e-3, atol 3e-3;
  params rtol 2e-3, atol 3e-3); against one process, the first step's
  losses within 1e-5 * (1 + |ref|), every step's within that or twice
  the floor's departure (below), and the state in
  ``tests/test_torch_port_dist_tp.py``'s envelope: within a few lr an
  Adam step (2 lr for the WGAN-GP's, 3 lr for the CGAN's), and within
  1e-5 but for 1 in 1000 elements plus twice the count that the one
  process's own floor leaves out (the same steps with each batch's rows
  and draws permuted, within each microbatch, two permutations).
- One ``--grad-accum 2`` step of each against the one process's
  accumulated step (the same envelope), and one K = 2 call of the
  WGAN-GP step bitwise two K = 1 steps.
- The replicated leaves bitwise equal on all four ranks, each slice on
  the two ranks of its model index (the CGAN G's ``fc.bias`` among them),
  and each rank's state bitwise its slice of the assembled whole;
  ``shard_over_model`` then ``whole_state_dict`` gives back the whole
  state bitwise for both nets of both families.
- The CGAN's FM loss through D's gathered taps (each tap whole on every
  rank) equal to one process's within 1e-6 relative.
- The penalty's double backward in float64 through the real critic
  (``gradient_penalty``, column-parallel convs, BN over the data group,
  ``all_reduce_grads``) against one process within 1e-10 relative, also
  after model rank 0 alone has run a differentiated penalty of its own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_cgan_step import _draws as cgan_draws
from tests.test_torch_port_dist_tp import (N_MODEL, PARAMS_TOL, POST_TOL,
                                           WORLD, _outside, _tp_mesh)
from tests.test_torch_port_wgan_step import _draws as wgan_draws
from tests.test_torch_port_wgan_step import _reference_init
from tests.torch_port_dist_worker import run_cases, tp_critic_penalty
from tests.torch_port_util import jax_cgan
from xgan.models import wgan as jax_wgan
from xgan.models.vgg import VGG16Features as JaxVGG
from xgan.parallel.tp import shard_over_model as jax_shard
from xgan.train.cgan import make_cgan_step
from xgan.train.common import ModelState
from xgan.train.common import adam as jax_adam
from xgan.train.wgan import make_wgan_step
from xgan_torch.models import cgan, wgan
from xgan_torch.models.convert import (cgan_discriminator_state_dict_from_jax,
                                       cgan_generator_state_dict_from_jax,
                                       critic_state_dict_from_jax,
                                       generator_state_dict_from_jax,
                                       vgg_state_dict_from_jax)
from xgan_torch.models.vgg import VGG16Features
from xgan_torch.train.cgan import cgan_step, feature_matching_loss
from xgan_torch.train.common import adam
from xgan_torch.train.wgan import wgan_step

torch.set_num_threads(1)

MIN_F = 64  # tests/test_tp.py's test-size width
LATENT, FM, SIZE, B, LR = 8, 32, 32, 16, 2e-4
N_CRITIC, LAMBDA = 2, 10.0
# Adam's largest move of a coordinate whose gradient is rounding noise,
# in lr an Adam step (tests/test_torch_port_dist_wgan.py, _cgan.py)
ADAM_LR = {"wgan": 2, "cgan": 3}


def _jax_states(mesh, pairs):
    """(params, batch_stats) and their optimizer -> ModelStates placed by
    the JAX package's rule over the model axis."""
    return [jax_shard(mesh, ModelState(params=v[0], batch_stats=v[1],
                                       opt_state=tx.init(v[0])),
                      min_features=MIN_F) for v, tx in pairs]


def _jax_wgan(mesh):
    """Two WGAN-GP steps of the JAX package's TP run; returns the initial
    and final torch state dicts (G, critic), the (2, 3) losses, the images
    and the port's steps (the JAX draws)."""
    g_model = jax_wgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                 image_size=SIZE)
    c_model = jax_wgan.Critic(feature_maps=FM, image_size=SIZE)
    g_tx, c_tx = jax_adam(LR, 0.5, beta2=0.9), jax_adam(LR, 0.5, beta2=0.9)
    g_vars = _reference_init(g_model, jnp.zeros((2, LATENT)), 70)
    c_vars = _reference_init(c_model, jnp.zeros((2, SIZE, SIZE, 3)), 71)
    init = (generator_state_dict_from_jax(*g_vars),
            critic_state_dict_from_jax(*c_vars))
    g_state, c_state = _jax_states(mesh, ((g_vars, g_tx), (c_vars, c_tx)))
    step = make_wgan_step(g_model, c_model, g_tx, c_tx, latent_dim=LATENT,
                          critic_iters=N_CRITIC, lambda_gp=LAMBDA,
                          batch_sharding=mesh.batch_sharding(4),
                          donate=False)
    images = np.random.default_rng(72).integers(0, 255, (32, SIZE, SIZE, 3),
                                                np.uint8)
    losses, steps = [], []
    for t, key in enumerate((jax.random.key(73), jax.random.key(74))):
        idx = np.arange(B) + B * t
        g_state, c_state, d_l, g_l = step(
            g_state, c_state, mesh.replicate(jnp.asarray(images)),
            jnp.asarray(idx, jnp.int32), key)
        losses.append(np.concatenate([np.asarray(d_l).reshape(-1),
                                      [float(g_l)]]))
        steps.append({"idx": torch.from_numpy(idx.astype(np.int64)),
                      "draws": wgan_draws(key, B, N_CRITIC)})
    final = (generator_state_dict_from_jax(*jax.device_get(
                 (g_state.params, g_state.batch_stats))),
             critic_state_dict_from_jax(*jax.device_get(
                 (c_state.params, c_state.batch_stats))))
    return init, final, np.stack(losses), images, steps


def _jax_cgan(mesh):
    """Two CGAN steps of the JAX package's TP run (VGG16 replicated, the
    gate open at epoch 0); returns the initial and final torch state dicts
    (G, D), the (2, 7) metrics, the images, labels, VGG16 state dict and
    the port's steps."""
    g_model, d_model, g_vars, d_vars = jax_cgan(LATENT, FM, SIZE, seed=75)
    vgg_model = JaxVGG()
    vgg_params = jax.device_get(vgg_model.init(
        jax.random.key(76), jnp.zeros((1, SIZE, SIZE, 3)))["params"])
    g_tx, d_tx = jax_adam(LR, 0.5), jax_adam(LR, 0.5)
    init = (cgan_generator_state_dict_from_jax(*g_vars),
            cgan_discriminator_state_dict_from_jax(*d_vars))
    g_state, d_state = _jax_states(mesh, ((g_vars, g_tx), (d_vars, d_tx)))
    step = make_cgan_step(g_model, d_model, vgg_model, g_tx, d_tx,
                          latent_dim=LATENT,
                          batch_sharding=mesh.batch_sharding(4),
                          donate=False)
    rng = np.random.default_rng(77)
    images = rng.integers(0, 255, (32, SIZE, SIZE, 3), np.uint8)
    labels = (np.arange(32) % 2).astype(np.int32)
    metrics, steps = [], []
    for t, key in enumerate((jax.random.key(78), jax.random.key(79))):
        idx = np.arange(B) + B * t
        g_state, d_state, m = step(
            g_state, d_state, mesh.replicate(vgg_params),
            mesh.replicate(jnp.asarray(images)),
            mesh.replicate(jnp.asarray(labels)),
            jnp.asarray(idx, jnp.int32), jnp.int32(0), key)
        metrics.append(np.asarray(m))
        steps.append({"idx": torch.from_numpy(idx.astype(np.int64)),
                      "epoch": 0, "draws": cgan_draws(key, B)})
    g_p, g_s, d_p, d_s = jax.device_get(
        (g_state.params, g_state.batch_stats, d_state.params,
         d_state.batch_stats))
    final = (cgan_generator_state_dict_from_jax(g_p, g_s),
             cgan_discriminator_state_dict_from_jax(d_p, d_s))
    return (init, final, np.stack(metrics), images, labels,
            vgg_state_dict_from_jax(vgg_params), steps)


def _nets(kind, init):
    if kind == "wgan":
        g, d = wgan.Generator(LATENT, 3, FM, SIZE), wgan.Critic(3, FM, SIZE)
    else:
        g, d = (cgan.Generator(LATENT, 2, 3, FM, SIZE),
                cgan.Discriminator(2, 3, FM, SIZE))
    g.load_state_dict(init[0])
    d.load_state_dict(init[1])
    return g, d


def _one(kind, init, data, steps, accum=1):
    """The port's one process over ``steps`` (no mask): the metrics and
    G's and D's state dicts."""
    g, d = _nets(kind, init)
    b2 = 0.9 if kind == "wgan" else 0.999
    og, od = adam(g.parameters(), LR, 0.5, b2), adam(d.parameters(), LR,
                                                     0.5, b2)
    images = torch.from_numpy(data["images"])
    if kind == "wgan":
        m = [wgan_step(g, d, og, od, images, s["idx"], latent_dim=LATENT,
                       critic_iters=N_CRITIC, lambda_gp=LAMBDA,
                       grad_accum=accum, **s["draws"]) for s in steps]
    else:
        vgg = VGG16Features()
        vgg.load_state_dict(data["vgg"])
        labels = torch.from_numpy(data["labels"].astype(np.int64))
        m = [cgan_step(g, d, vgg, og, od, images, labels, s["idx"],
                       s["epoch"], latent_dim=LATENT, grad_accum=accum,
                       **s["draws"]) for s in steps]
    return torch.stack(m).numpy(), {"g": g.state_dict(), "d": d.state_dict()}


def _permute(v, perm):
    if isinstance(v, list):
        return [_permute(x, perm) for x in v]
    if torch.is_tensor(v) and v.dim() and v.shape[0] == B:
        return v[perm]
    return v


def _permuted(steps, seed: int, accum: int = 1):
    """``steps`` with each batch's rows and their draws permuted within
    each of its ``accum`` microbatches (whose BN batches they are): one
    process's floor of reduction order."""
    rng, mb = np.random.default_rng(seed), B // accum
    perm = torch.from_numpy(np.concatenate(
        [i * mb + rng.permutation(mb) for i in range(accum)]))
    return [{k: ({n: _permute(x, perm) for n, x in v.items()}
                 if k == "draws" else _permute(v, perm))
             for k, v in s.items()} for s in steps]


def _flat(state: dict) -> dict:
    return {f"{n}.{k}": v for n in ("g", "d") for k, v in state[n].items()}


def _penalty_inputs():
    """A float64 critic (fd 32, N(0, 0.2/fan) weights so that the convs
    keep a unit gain, random BN) and the rows of its penalty."""
    c = wgan.Critic(3, FM, SIZE,
                    generator=torch.Generator().manual_seed(80))
    rng = np.random.default_rng(81)
    sd = {}
    for k, v in c.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd[k] = v
        elif v.dim() == 4:
            sd[k] = torch.from_numpy(rng.normal(size=v.shape)
                                     * np.sqrt(2.0 / v[0].numel()))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(0.5 + rng.random(v.shape))
        else:
            base = 1.0 if k.endswith("weight") else 0.0
            sd[k] = torch.from_numpy(base + 0.1 * rng.normal(size=v.shape))
    sd = {k: v.double() if v.is_floating_point() else v
          for k, v in sd.items()}

    def t(*shape):
        return torch.from_numpy(rng.uniform(-1, 1, size=shape))

    return {"c": sd, "real": t(B, SIZE, SIZE, 3), "fake": t(B, SIZE, SIZE, 3),
            "alpha": torch.from_numpy(rng.random((B, 1, 1, 1)))}


def _one_penalty(pen):
    """The one process's float64 penalty and critic gradients."""
    c = wgan.Critic(3, FM, SIZE)
    c.double()
    c.dtype = torch.float64
    c.load_state_dict(pen["c"])
    return tp_critic_penalty(c, pen, slice(None), None)


def _one_fm(init, fm_in):
    _, d = _nets("cgan", init)
    feats = [d(fm_in[k], fm_in["labels"], train=True, features=True)[1]
             for k in ("real", "fake")]
    return feature_matching_loss(*feats).detach(), \
        [tuple(f.shape) for f in feats[0]]


@pytest.fixture(scope="module")
def tp_gans_run(tmp_path_factory):
    mesh = _tp_mesh()
    w_init, w_final, w_losses, w_images, w_steps = _jax_wgan(mesh)
    (c_init, c_final, c_metrics, c_images, c_labels, vgg,
     c_steps) = _jax_cgan(mesh)
    data = {"wgan": {"images": w_images},
            "cgan": {"images": c_images, "labels": c_labels, "vgg": vgg}}
    pen = _penalty_inputs()
    rng = np.random.default_rng(82)
    fm_in = {"real": torch.from_numpy(rng.uniform(-1, 1, (B, SIZE, SIZE, 3))
                                      .astype(np.float32)),
             "fake": torch.from_numpy(rng.uniform(-1, 1, (B, SIZE, SIZE, 3))
                                      .astype(np.float32)),
             "labels": torch.from_numpy(np.arange(B) % 2)}
    common = {"latent": LATENT, "fm": FM, "size": SIZE, "lr": LR}
    inputs = {"tp_gans": {
        "model_parallel": N_MODEL, "min": MIN_F, "penalty": pen,
        "fm": fm_in,
        "wgan": {**common, "critic_iters": N_CRITIC, "lambda_gp": LAMBDA,
                 "g": w_init[0], "d": w_init[1],
                 "images": torch.from_numpy(w_images), "steps": w_steps},
        "cgan": {**common, "g": c_init[0], "d": c_init[1], "vgg": vgg,
                 "images": torch.from_numpy(c_images),
                 "labels": torch.from_numpy(c_labels.astype(np.int64)),
                 "steps": c_steps}}}
    ranks = run_cases(inputs, tmp_path_factory.mktemp("dist_tp_gans"), WORLD,
                      timeout=600)["tp_gans"]
    one, floor = {}, {}
    for kind, init, steps in (("wgan", w_init, w_steps),
                              ("cgan", c_init, c_steps)):
        for run, st, accum in (("tp", steps, 1), ("accum", steps[:1], 2)):
            one[kind, run] = _one(kind, init, data[kind], st, accum)
            m, state = one[kind, run]
            perms = [_one(kind, init, data[kind], _permuted(st, seed, accum),
                          accum) for seed in (0, 1)]
            floor[kind, run] = (
                max(_outside(_flat(p[1]), _flat(state))[0] for p in perms),
                max(_rel(p[0], m).max() for p in perms))
    return {"ranks": ranks, "one": one, "floor": floor,
            "jax": {"wgan": (w_final, w_losses), "cgan": (c_final,
                                                          c_metrics)},
            "inits": {"wgan": w_init, "cgan": c_init},
            "penalty": _one_penalty(pen), "fm": _one_fm(c_init, fm_in)}


def test_layout_is_the_jax_mesh(tp_gans_run):
    got = [(r["data_rank"], r["model_rank"]) for r in tp_gans_run["ranks"]]
    assert got == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("kind", ["wgan", "cgan"])
def test_steps_match_the_jax_tp_run(tp_gans_run, kind):
    final, metrics = tp_gans_run["jax"][kind]
    for r in tp_gans_run["ranks"]:
        run = r[f"{kind}_tp"]
        np.testing.assert_allclose(run["metrics"].numpy(), metrics,
                                   **POST_TOL)
        for net, want in zip(("g", "d"), final):
            for k, v in want.items():
                np.testing.assert_allclose(run["whole"][net][k].numpy(),
                                           v.numpy(), **PARAMS_TOL,
                                           err_msg=f"{kind} {net}.{k}")


@pytest.mark.parametrize("kind,run", [("wgan", "tp"), ("wgan", "accum"),
                                      ("cgan", "tp"), ("cgan", "accum")])
def test_steps_match_one_process(tp_gans_run, kind, run):
    metrics, state = tp_gans_run["one"][kind, run]
    got = tp_gans_run["ranks"][0][f"{kind}_{run}"]
    floor_out, floor_rel = tp_gans_run["floor"][kind, run]
    rel = _rel(got["metrics"].numpy(), metrics)
    assert rel[0].max() <= 1e-5, rel[0]
    assert rel.max() <= max(1e-5, 2 * floor_rel), (rel, floor_rel)
    outside, total, worst = _outside(_flat(got["whole"]), _flat(state))
    assert worst <= ADAM_LR[kind] * LR * _adam_steps(kind, len(metrics)), \
        worst
    assert outside <= total // 1000 + 2 * floor_out, \
        (outside, total, floor_out)


def _rel(got, want):
    return np.abs(got - want) / (1 + np.abs(want))


def _adam_steps(kind, steps):
    return steps * N_CRITIC if kind == "wgan" else steps


RUNS = ["wgan_tp", "wgan_k2", "wgan_accum", "cgan_tp", "cgan_accum"]


def _locals(r, run):
    out = r[run]
    return [(f"{n}.{k}", v, k in out["dims"][n])
            for n in ("g", "d") for k, v in out["local"][n].items()]


@pytest.mark.parametrize("run", RUNS)
def test_replicated_leaves_stay_bitwise_equal(tp_gans_run, run):
    """The replicated leaves on all four ranks, a slice on the two ranks
    of its model index; the slices of the two model indices differ."""
    every = [_locals(r, run) for r in tp_gans_run["ranks"]]
    sliced = set()
    for i, (name, v, is_sliced) in enumerate(every[0]):
        for p in ((2,) if is_sliced else (1, 2, 3)):
            assert torch.equal(v, every[p][i][1]), (run, name, p)
        if is_sliced:
            sliced.add(name)
            assert torch.equal(every[1][i][1], every[3][i][1]), (run, name)
            assert not torch.equal(v, every[1][i][1]), (run, name)
    assert sliced, run
    if run.startswith("cgan"):  # the bias sliced without its weight
        assert "g.fc.bias" in sliced and "g.fc.weight" not in sliced


@pytest.mark.parametrize("run", RUNS)
def test_each_slice_is_its_rank_slice_of_the_whole(tp_gans_run, run):
    for r in tp_gans_run["ranks"]:
        out = r[run]
        for n in ("g", "d"):
            for k, v in out["local"][n].items():
                w = out["whole"][n][k]
                if k in out["dims"][n]:
                    d = out["dims"][n][k]
                    k_ = v.shape[d]
                    assert w.shape[d] == N_MODEL * k_, (run, n, k)
                    w = w.narrow(d, r["model_rank"] * k_, k_)
                assert torch.equal(v, w), (run, n, k)


def test_k2_is_bitwise_k1(tp_gans_run):
    for r in tp_gans_run["ranks"]:
        a, b = r["wgan_tp"], r["wgan_k2"]
        assert torch.equal(a["metrics"], b["metrics"])
        for net in ("g", "d"):
            for k, v in a["whole"][net].items():
                assert torch.equal(v, b["whole"][net][k]), (net, k)


@pytest.mark.parametrize("kind,net", [("wgan", "g"), ("wgan", "d"),
                                      ("cgan", "g"), ("cgan", "d")])
def test_shard_over_model_round_trip(tp_gans_run, kind, net):
    want = tp_gans_run["inits"][kind][("g", "d").index(net)]
    for r in tp_gans_run["ranks"]:
        got = r[f"{kind}_round_trip"][net]
        assert got["dims"], (kind, net)  # something is sliced at width 64
        assert got["whole"].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got["whole"][k], v), (kind, net, k)


def test_fm_loss_through_gathered_taps_is_one_process(tp_gans_run):
    want, shapes = tp_gans_run["fm"]
    rows = B // 2
    for r in tp_gans_run["ranks"]:
        got = r["fm"]
        # every tap whole on every rank (this data rank's rows)
        assert got["shapes"] == [(rows, *s[1:]) for s in shapes]
        torch.testing.assert_close(got["loss"], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("run", ["penalty", "penalty_after_lone"])
def test_penalty_double_backward_through_the_tp_critic(tp_gans_run, run):
    """float64: the penalty and every parameter's gradient (this rank's
    slice of a sliced one) within 1e-10 relative of one process; also
    after model rank 0 alone has run a differentiated penalty of its own
    (``penalty_after_lone``: the order of the group's collectives does
    not depend on a rank's autograd history)."""
    value, grads = tp_gans_run["penalty"]
    tol = dict(rtol=1e-10, atol=1e-12)
    sliced = 0
    for r in tp_gans_run["ranks"]:
        got = r[run]
        torch.testing.assert_close(got["value"], value, **tol)
        for name, want in grads.items():
            d = got["dims"].get(name)
            if d is not None:
                sliced += 1
                k = want.shape[d] // N_MODEL
                want = want.narrow(d, r["model_rank"] * k, k)
            torch.testing.assert_close(got["grads"][name], want, **tol,
                                       msg=name)
    assert sliced
