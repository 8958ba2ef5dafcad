"""xgan_torch's tensor parallelism (``--model-parallel 2``) on four gloo
ranks on the CPU, laid out as the JAX package's ``(data, model)`` mesh
(data 2 x model 2; ``tests/torch_port_dist_worker.py``'s ``tp`` case, one
launch), against the JAX package's ``(data=4, model=2)`` TP runs on the 8
emulated devices (``tests/test_tp.py``'s, ``MIN_F`` = 64) and against the
port's one process.

- Two DCGAN steps (fg 32, latent 8, 32 px, B = 16, as
  ``tests/test_tp.py``'s ``_dcgan_run``; the JAX step's own draws
  injected): the metrics and G's and D's parameters and BN buffers at
  that file's post-update tolerances (rtol 5e-3, atol 3e-3; params rtol
  2e-3, atol 3e-3); against one process, the metrics within 1e-5 and the
  state within 2 lr a step, and within 1e-5 but for at most 1 in 1000
  elements plus twice the count that the one process's own floor leaves
  out (the same steps with each batch's rows permuted, two draws):
  ``tests/test_torch_port_dist_gan.py``'s DP envelope, whose 1 in 1000
  the floor alone exceeds at fg 32 (up to 1.9 in 1000 here).
- The classifier (``stage_sizes`` (1,1,1,1), mode real, B = 16 of 64
  images): 3 steps with the base frozen and 1 unfrozen, as
  ``tests/test_tp.py``'s ``_run``: the per-sample losses at rtol 2e-4,
  atol 2e-5, the eval outputs after the update at rtol 5e-3, atol 3e-3
  unfrozen (2e-4, 2e-5 frozen), the state at rtol 2e-3, atol 3e-3;
  against one process, the losses within 1e-5 and the state in that
  envelope (lr 1e-3, its own floor).
- In the same launch: the replicated leaves bitwise equal on all four
  ranks, each sliced leaf bitwise equal on the ranks of one model index;
  each rank's state bitwise this rank's slice of the assembled whole;
  ``--grad-accum 2`` against one process's accumulated step (the DP
  envelope); ZeRO-1 over the data ranks bitwise the TP run's parameters,
  its whole optimizer state too; one K = 2 call bitwise two K = 1 steps;
  the classifier under ``remat`` bitwise without it.
- ``shard_over_model`` then ``whole_state_dict`` gives back the whole
  state bitwise for G at 32 and 64 px, D and the ResNet; a 64-px G's
  packed first ConvT holds this rank's channels at each of its 2 x 2
  pixels, not a block of the packed matrix's columns.
- The three operators' float64 first and second derivatives (an input
  gradient, then a penalty on its norms differentiated in the weights)
  against one process within 1e-10 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_dist_gan import _draws, _state_dicts
from tests.torch_port_dist_worker import run_cases, tp_penalty
from xgan.models import dcgan as jax_dcgan
from xgan.models.resnet import ResNet50 as JaxResNet50
from xgan.parallel import create_mesh
from xgan.parallel.tp import shard_over_model as jax_shard
from xgan.train.classifier import classifier_optimizer as jax_clf_opt
from xgan.train.classifier import make_eval_step, make_train_step
from xgan.train.common import ModelState, adam as jax_adam, create_state
from xgan.train.gan import make_dcgan_step
from xgan_torch.models.convert import resnet_state_dict_from_flax
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.models.resnet import ResNet50
from xgan_torch.train.classifier import (classifier_optimizer, eval_step,
                                         train_step)
from xgan_torch.train.common import adam
from xgan_torch.train.gan import dcgan_step

torch.set_num_threads(1)

MIN_F = 64  # tests/test_tp.py's test-size width
N_MODEL, WORLD = 2, 4
LATENT, FM, SIZE, B, GAN_LR, CLF_LR = 8, 32, 32, 16, 2e-4, 1e-3
STAGES = (1, 1, 1, 1)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)   # tests/test_tp.py:117
POST_TOL = dict(rtol=5e-3, atol=3e-3)   # tests/test_tp.py:125
PARAMS_TOL = dict(rtol=2e-3, atol=3e-3)  # tests/test_tp.py:131


def _tp_mesh():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 emulated devices")
    return create_mesh(devices=devs[:8], model_parallel=N_MODEL)


def _jax_dcgan(mesh):
    """Two DCGAN steps of the JAX package's TP run; returns the initial
    and final torch state dicts, the (2, 5) metrics, the images and the
    port's steps (the JAX draws)."""
    g_model = jax_dcgan.Generator(latent_dim=LATENT, feature_maps=FM,
                                  image_size=SIZE)
    d_model = jax_dcgan.Discriminator(feature_maps=FM, image_size=SIZE)
    g_tx, d_tx = jax_adam(GAN_LR, 0.5), jax_adam(GAN_LR, 0.5)
    k = jax.random.key(0)
    g_state = create_state(g_model, g_tx, k, jnp.zeros((2, LATENT)),
                           train=False)
    d_state = create_state(d_model, d_tx, k, jnp.zeros((2, SIZE, SIZE, 3)),
                           train=False)
    init = _state_dicts(g_state, d_state)
    g_state = jax_shard(mesh, g_state, min_features=MIN_F)
    d_state = jax_shard(mesh, d_state, min_features=MIN_F)
    step = make_dcgan_step(g_model, d_model, g_tx, d_tx, latent_dim=LATENT,
                           batch_sharding=mesh.batch_sharding(4),
                           donate=False)
    images = np.random.default_rng(0).integers(0, 255, (32, SIZE, SIZE, 3),
                                               np.uint8)
    metrics, steps = [], []
    for t, key in enumerate((jax.random.key(7), jax.random.key(8))):
        idx = np.arange(B) + B * t
        g_state, d_state, m = step(g_state, d_state,
                                   mesh.replicate(jnp.asarray(images)),
                                   jnp.asarray(idx, jnp.int32), key)
        metrics.append(np.asarray(m))
        flip, noise = _draws(key)
        steps.append({"idx": torch.from_numpy(idx.astype(np.int64)),
                      "flip": flip, "noise": noise})
    return init, _state_dicts(g_state, d_state), np.stack(metrics), \
        images, steps


def _jax_clf(mesh, freeze_base: bool):
    """``tests/test_tp.py``'s ``_run`` under TP: 3 steps frozen or 1
    unfrozen, the eval step; returns the initial torch state dict, the
    per-sample losses, the final state dict and the eval outputs, with
    the images, labels and the port's steps."""
    model = JaxResNet50(num_classes=2, stage_sizes=STAGES)
    variables = model.init(jax.random.key(0), jnp.zeros((2, SIZE, SIZE, 3)),
                           train=False)
    tx = jax_clf_opt(CLF_LR, freeze_base=freeze_base)
    state = ModelState(params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    init = resnet_state_dict_from_flax(*jax.device_get(
        (state.params, state.batch_stats)), STAGES)
    state = jax_shard(mesh, state, min_features=MIN_F)
    bsh = mesh.batch_sharding(4)
    step = make_train_step(model, tx, mode="real", batch_sharding=bsh)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 255, (64, SIZE, SIZE, 3), np.uint8)
    labels = rng.integers(0, 2, (64,), np.int64).astype(np.int32)
    rep = mesh.replicate
    dummy = rep(jnp.zeros((1, SIZE, SIZE, 3), jnp.uint8))
    dummy_l = rep(jnp.zeros((1,), jnp.int32))
    losses, steps = [], []
    for i in range(3 if freeze_base else 1):
        idx = (np.arange(B) + B * i) % 64
        key = jax.random.key(100 + i)
        state, per_loss, _, _ = step(
            state, rep(jnp.asarray(images)), rep(jnp.asarray(labels)),
            dummy, dummy_l, jnp.asarray(idx, jnp.int32), jnp.float32(0.0),
            key)
        losses.append(np.asarray(per_loss))
        _, k_flip = jax.random.split(key)
        steps.append({"idx": torch.from_numpy(idx.astype(np.int64)),
                      "flip": torch.from_numpy(np.array(
                          jax.random.bernoulli(k_flip, 0.5, (B,))))})
    ev = make_eval_step(model, batch_sharding=bsh)(
        state.variables(), rep(jnp.asarray(images)),
        jnp.arange(B, dtype=jnp.int32), rep(jnp.asarray(labels)))
    final = resnet_state_dict_from_flax(*jax.device_get(
        (state.params, state.batch_stats)), STAGES)
    return (init, np.stack(losses), final, [np.asarray(e) for e in ev],
            images, labels, steps)


def _permuted(steps, seed: int):
    """``steps`` with each batch's rows (and their draws) permuted: one
    process's floor of reduction order."""
    perm = torch.from_numpy(np.random.default_rng(seed).permutation(B))
    return [{k: v[perm] for k, v in s.items()} for s in steps]


def _one_dcgan(init, images, steps, accum=1):
    g, d = Generator(LATENT, 3, FM, SIZE), Discriminator(3, FM, SIZE)
    g.load_state_dict(init[0])
    d.load_state_dict(init[1])
    og, od = adam(g.parameters(), GAN_LR, 0.5), adam(d.parameters(), GAN_LR,
                                                     0.5)
    m = [dcgan_step(g, d, og, od, torch.from_numpy(images), s["idx"],
                    latent_dim=LATENT, flip=s["flip"], noise=s["noise"],
                    grad_accum=accum) for s in steps]
    return torch.stack(m).numpy(), {"g": g.state_dict(), "d": d.state_dict()}


def _one_clf(init, images, labels, steps, frozen):
    from tests.torch_port_dist_worker import _store
    from xgan_torch.data.pipeline import DeviceStore
    model = ResNet50(2, stage_sizes=STAGES)
    model.load_state_dict(init)
    opt = classifier_optimizer(model, CLF_LR, freeze_base=frozen)
    store = DeviceStore(_store(images, labels), "cpu")
    losses = [train_step(model, opt, store, store, s["idx"], mode="real",
                         flip=s["flip"])[0] for s in steps]
    ev = eval_step(model, store, torch.arange(B))
    return torch.stack(losses).numpy(), model.state_dict(), \
        [e.numpy() for e in ev]


def _ops_inputs():
    rng = np.random.default_rng(9)

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(size=shape) * scale)

    return {"x": t(8, 6), "ws": [t(6, 8, scale=0.4), t(8, 4, scale=0.4),
                                 t(4, 3, scale=0.5), t(3, scale=0.1)]}


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    mesh = _tp_mesh()
    g_init, g_final, g_metrics, images, gan_steps = _jax_dcgan(mesh)
    clf = {frozen: _jax_clf(mesh, frozen) for frozen in (True, False)}
    c_init, _, _, _, c_images, c_labels, c_steps = clf[True]
    g64 = Generator(LATENT, 3, FM, 64,
                    generator=torch.Generator().manual_seed(5)).state_dict()
    ops = _ops_inputs()
    inputs = {"tp": {
        "model_parallel": N_MODEL, "min": MIN_F, "g64": g64, "ops": ops,
        "gan": {"latent": LATENT, "fm": FM, "size": SIZE, "lr": GAN_LR,
                "g": g_init[0], "d": g_init[1],
                "images": torch.from_numpy(images), "steps": gan_steps},
        "clf": {"model": c_init, "stages": STAGES, "lr": CLF_LR,
                "images": torch.from_numpy(c_images),
                "labels": torch.from_numpy(c_labels), "steps": c_steps}}}
    ranks = run_cases(inputs, tmp_path_factory.mktemp("dist_tp"), WORLD,
                      timeout=600)["tp"]
    one, floor = {}, {}
    runs = {"gan": lambda st: _one_dcgan(g_init, images, st),
            "accum": lambda st: _one_dcgan(g_init, images, st[:1], accum=2),
            "frozen": lambda st: _one_clf(c_init, c_images, c_labels, st,
                                          True),
            "unfrozen": lambda st: _one_clf(c_init, c_images, c_labels,
                                            st[:1], False)}
    for name, run in runs.items():
        st = c_steps if name in ("frozen", "unfrozen") else gan_steps
        one[name] = run(st)
        floor[name] = max(_outside(_flat_state(run(_permuted(st, seed))[1]),
                                   _flat_state(one[name][1]))[0]
                          for seed in (0, 1))
    want_ops = tp_penalty_grads(ops)
    return {"ranks": ranks, "jax_gan": (g_final, g_metrics), "jax_clf": clf,
            "one": one, "floor": floor, "ops": want_ops, "g64": g64,
            "inits": {"g32": g_init[0], "d": g_init[1], "resnet": c_init}}


def tp_penalty_grads(ops):
    """The one-process derivatives of the worker's ``tp_penalty``."""
    ws = [w.clone().requires_grad_(True) for w in ops["ws"]]
    g, pen = tp_penalty(ops["x"], ws, None, ops["x"].shape[0])
    pen.backward()
    return g.detach(), [w.grad for w in ws]


def _flat_state(state: dict) -> dict:
    """G's and D's state dicts as one (``g.``/``d.`` keys), or a
    classifier's as it is."""
    if set(state) == {"g", "d"}:
        return {f"{n}.{k}": v for n in ("g", "d") for k, v in
                state[n].items()}
    return state


def _outside(got: dict, want: dict) -> tuple:
    """(elements more than 1e-5 apart, elements, worst |got - want|) over
    the float tensors of ``want``."""
    outside = total = 0
    worst = 0.0
    for k, v in want.items():
        if v.is_floating_point():
            d = (got[k].double() - v.double()).abs()
            outside += int((d > 1e-5).sum())
            total += d.numel()
            worst = max(worst, d.max().item())
    return outside, total, worst


def _close_in_envelope(got: dict, want: dict, steps: int, lr: float,
                       floor: int):
    """Every float tensor within 2 lr a step, and within 1e-5 but for at
    most 1 in 1000 elements plus twice ``floor`` (see the module
    docstring)."""
    outside, total, worst = _outside(_flat_state(got), _flat_state(want))
    assert worst <= 2 * lr * steps, worst
    assert outside <= total // 1000 + 2 * floor, (outside, total, floor)


def test_layout_is_the_jax_mesh(tp_run):
    """Rank r at data index r // 2 and model index r % 2; rank 0 alone
    writes."""
    got = [(r["data_rank"], r["model_rank"], r["is_main"])
           for r in tp_run["ranks"]]
    assert got == [(0, 0, True), (0, 1, False), (1, 0, False), (1, 1, False)]


def test_dcgan_steps_match_the_jax_tp_run(tp_run):
    g_final, metrics = tp_run["jax_gan"]
    for r in tp_run["ranks"]:
        run = r["gan_tp"]
        np.testing.assert_allclose(run["metrics"].numpy(), metrics,
                                   **POST_TOL)
        for net, want in zip(("g", "d"), g_final):
            for k, v in want.items():
                np.testing.assert_allclose(run["whole"][net][k].numpy(),
                                           v.numpy(), **PARAMS_TOL,
                                           err_msg=f"{net}.{k}")


@pytest.mark.parametrize("run", ["tp", "accum"])
def test_dcgan_steps_match_one_process(tp_run, run):
    metrics, state = tp_run["one"]["gan" if run == "tp" else "accum"]
    got = tp_run["ranks"][0][f"gan_{run}"]
    np.testing.assert_allclose(got["metrics"].numpy(), metrics, rtol=0,
                               atol=1e-5)
    _close_in_envelope(got["whole"], state, len(metrics), GAN_LR,
                       tp_run["floor"]["gan" if run == "tp" else "accum"])


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen",
                                                       "unfrozen"])
def test_classifier_steps_match_the_jax_tp_run(tp_run, frozen):
    _, losses, final, ev, *_ = tp_run["jax_clf"][frozen]
    post = dict(rtol=2e-4, atol=2e-5) if frozen else POST_TOL
    for r in tp_run["ranks"]:
        run = r["clf_frozen" if frozen else "clf_unfrozen"]
        np.testing.assert_allclose(run["losses"].numpy(), losses, **LOSS_TOL)
        for a, b in zip(run["eval"], ev):
            np.testing.assert_allclose(a.numpy().astype(np.float64),
                                       b.astype(np.float64), **post)
        for k, v in final.items():
            if v.is_floating_point():
                np.testing.assert_allclose(run["whole"][k].numpy(),
                                           v.numpy(), **PARAMS_TOL,
                                           err_msg=k)


@pytest.mark.parametrize("frozen", [True, False], ids=["frozen",
                                                       "unfrozen"])
def test_classifier_steps_match_one_process(tp_run, frozen):
    name = "frozen" if frozen else "unfrozen"
    losses, state, ev = tp_run["one"][name]
    got = tp_run["ranks"][0][f"clf_{name}"]
    np.testing.assert_allclose(got["losses"].numpy(), losses, rtol=0,
                               atol=1e-5)
    _close_in_envelope(got["whole"], state, len(losses), CLF_LR,
                       tp_run["floor"][name])


RUNS = ["gan_tp", "gan_k2", "gan_zero", "gan_accum", "clf_frozen",
        "clf_unfrozen", "clf_remat"]


def _locals(r, run):
    out = r[run]
    if run.startswith("gan"):
        return [(f"{n}.{k}", v, k in out["dims"][n])
                for n in ("g", "d") for k, v in out["local"][n].items()]
    return [(k, v, k in out["dims"]) for k, v in out["local"].items()]


@pytest.mark.parametrize("run", RUNS)
def test_replicated_leaves_stay_bitwise_equal(tp_run, run):
    """The replicated leaves on all four ranks, a slice on the two ranks
    of its model index; the slices of the two model indices differ."""
    ranks = tp_run["ranks"]
    every = [_locals(r, run) for r in ranks]
    sliced = 0
    for i, (name, v, is_sliced) in enumerate(every[0]):
        peers = (2,) if is_sliced else (1, 2, 3)
        for p in peers:
            assert torch.equal(v, every[p][i][1]), (run, name, p)
        if is_sliced:
            sliced += 1
            assert torch.equal(every[1][i][1], every[3][i][1]), (run, name)
    assert sliced, run


@pytest.mark.parametrize("run", RUNS)
def test_each_slice_is_its_rank_slice_of_the_whole(tp_run, run):
    for r in tp_run["ranks"]:
        out = r[run]
        pairs = ([(out["local"][n], out["whole"][n], out["dims"][n])
                  for n in ("g", "d")] if run.startswith("gan")
                 else [(out["local"], out["whole"], out["dims"])])
        for local, whole, dims in pairs:
            for k, v in local.items():
                w = whole[k]
                if k in dims:
                    d = dims[k]
                    n = v.shape[d]
                    assert w.shape[d] == N_MODEL * n, k
                    w = w.narrow(d, r["model_rank"] * n, n)
                assert torch.equal(v, w), (run, k)


def test_zero1_is_bitwise_the_tp_run(tp_run):
    for r in tp_run["ranks"]:
        a, b = r["gan_tp"], r["gan_zero"]
        assert torch.equal(a["metrics"], b["metrics"])
        for net in ("g", "d"):
            for k, v in a["whole"][net].items():
                assert torch.equal(v, b["whole"][net][k]), (net, k)
        for sa, sb in zip(a["opt_whole"], b["opt_whole"]):
            assert sa["state"].keys() == sb["state"].keys()
            for i, st in sa["state"].items():
                for key, v in st.items():
                    assert torch.equal(v, sb["state"][i][key]), (i, key)


def test_k2_is_bitwise_k1(tp_run):
    for r in tp_run["ranks"]:
        a, b = r["gan_tp"], r["gan_k2"]
        assert torch.equal(a["metrics"], b["metrics"])
        for net in ("g", "d"):
            for k, v in a["whole"][net].items():
                assert torch.equal(v, b["whole"][net][k]), (net, k)


def test_remat_is_bitwise_without(tp_run):
    for r in tp_run["ranks"]:
        a, b = r["clf_unfrozen"], r["clf_remat"]
        assert torch.equal(a["losses"], b["losses"])
        for k, v in a["whole"].items():
            assert torch.equal(v, b["whole"][k]), k


@pytest.mark.parametrize("net", ["g32", "g64", "d", "resnet"])
def test_shard_over_model_round_trip(tp_run, net):
    want = tp_run["g64"] if net == "g64" else tp_run["inits"][net]
    for r in tp_run["ranks"]:
        got = r["round_trip"][net]
        assert got["dims"], net  # something is sliced at width 64
        assert got["whole"].keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(got["whole"][k], v), (net, k)


def test_packed_first_convt_holds_the_rank_channels(tp_run):
    """At 64 px the first ConvT covers 2 x 2 pixels: the packed matrix's
    columns are (h, w, c). Each rank's ``w0_mat`` is its channels at
    every pixel, which a contiguous block of the whole matrix's columns
    is not."""
    g = Generator(LATENT, 3, FM, 64)
    g.load_state_dict(tp_run["g64"])
    whole = g.w0_mat  # (latent, 2 * 2 * C0)
    c0 = whole.shape[1] // 4
    for r in tp_run["ranks"]:
        got = r["round_trip"]["g64"]["w0_mat"]
        k = c0 // N_MODEL
        m = r["model_rank"]
        want = whole.reshape(LATENT, 2, 2, c0)[..., m * k:(m + 1) * k]
        assert torch.equal(got, want.reshape(LATENT, -1))
        block = whole[:, m * got.shape[1]:(m + 1) * got.shape[1]]
        assert not torch.equal(got, block)


def test_operators_first_and_second_derivatives(tp_run):
    dx, grads = tp_run["ops"]
    ranks = tp_run["ranks"]
    rows = dx.shape[0] // 2
    tol = dict(rtol=1e-10, atol=1e-12)
    for r in ranks:
        d = r["data_rank"]
        torch.testing.assert_close(r["ops"]["dx"],
                                   dx[d * rows:(d + 1) * rows], **tol)
        m = r["model_rank"]
        for got, want, dim in zip(r["ops"]["grads"], grads, (1, 1, 0, None)):
            if dim is not None:
                k = want.shape[dim] // N_MODEL
                want = want.narrow(dim, m * k, k)
            torch.testing.assert_close(got, want, **tol)
