"""xgan_torch's classifier step and sharded store across two gloo ranks on
the CPU (``tests/torch_port_dist_worker.py``) against the JAX package on
a 2-device CPU mesh.

- One ``--unfreeze`` step in concat and in mix mode, and in mix mode with
  a masked tail, from the same weights and the JAX step's own draws,
  against ``make_train_step(batch_sharding=..., use_pallas_gather=True,
  pallas_interpret=True)`` (the Pallas gather through
  ``mixed_gather_spmd``): the mean loss and the global per-sample
  losses of the valid rows within 1e-5 relative, ``fc`` and the BN running statistics within 1e-4
  (tests/test_torch_port_classifier.py's tolerances), on both ranks.
- Each rank's gathered u8 rows (``mixed_gather_ranks``) bitwise equal to
  its rows of ``mixed_gather_spmd`` in interpret mode on the mesh.
- The sharded ``take`` bitwise equal to ``make_sharded_take`` (N = 20 and
  N = 21 over 2 ranks, ``len()`` logical, each rank holding N/2 rounded
  up); the steps over a sharded real store equal the replicated store's
  bitwise, on both ranks; both ranks' models bitwise equal.
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
from xgan.data.pipeline import DeviceStore as JaxDeviceStore
from xgan.data.store import ImageStore as JaxImageStore
from xgan.ops.pallas.gather import mixed_gather_spmd
from xgan.parallel import create_mesh
from xgan.train.classifier import classifier_optimizer as jax_optimizer
from xgan.train.classifier import make_train_step
from xgan.train.common import ModelState

torch.set_num_threads(1)

SIZE, B, NR, NS, STAGES = 32, 8, 12, 5, (1, 1, 1, 1)
RATIO, LR = 0.5, 1e-3
# name -> (mode, sharded real store, masked tail)
RUNS = {"concat": ("concat", False, False), "mix": ("mix", False, False),
        "mix_tail": ("mix", False, True), "concat_sharded": ("concat", True,
                                                              False),
        "mix_sharded": ("mix", True, False)}
TAKE_N = (20, 21)


def _mesh():
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 emulated devices")
    return create_mesh(devices=devs[:2])


@pytest.fixture(scope="module")
def clf_run(tmp_path_factory):
    mesh = _mesh()
    fmodel, params, stats = jax_resnet(seed=3)
    real, real_labels, synth, synth_labels = _stores(3)
    idx = {"mix": np.array([4, 0, 9, 1, 7, 3, 10, 6], np.int32),
           "concat": np.array([0, 12, 16, 3, 13, 11, 15, 1], np.int32)}
    mask = np.array([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    key = jax.random.key(12)
    k_mix, k_flip = jax.random.split(key)
    use_synth, pick = _mix_draws(k_mix, RATIO, NS)
    flip = torch.from_numpy(np.array(jax.random.bernoulli(k_flip, 0.5,
                                                          (B,))))
    rep = mesh.replicate
    want, gathers = {}, {}
    for name, (mode, shard, masked) in RUNS.items():
        if shard:
            continue
        tx = jax_optimizer(LR, freeze_base=False)
        state = rep(ModelState(params=params, batch_stats=stats,
                               opt_state=tx.init(params)))
        step = make_train_step(fmodel, tx, mode=mode,
                               batch_sharding=mesh.batch_sharding(4),
                               use_pallas_gather=True, pallas_interpret=True)
        new_state, losses, _, _ = step(
            state, rep(jnp.asarray(real)), rep(jnp.asarray(real_labels)),
            rep(jnp.asarray(synth)), rep(jnp.asarray(synth_labels)),
            jnp.asarray(idx[mode]), jnp.float32(RATIO), key,
            mask=jnp.asarray(mask) if masked else None)
        want[name] = (np.asarray(losses), jax.device_get(new_state))
    for mode in ("concat", "mix"):
        if mode == "mix":
            ridx, sidx, use = idx[mode], pick.numpy().astype(np.int32), \
                use_synth.numpy()
        else:
            i = idx[mode]
            use = i >= NR
            ridx = np.where(use, 0, i).astype(np.int32)
            sidx = np.where(use, i - NR, 0).astype(np.int32)
        gathers[mode] = np.asarray(mixed_gather_spmd(
            rep(jnp.asarray(real)), rep(jnp.asarray(synth)),
            jnp.asarray(ridx), jnp.asarray(sidx), jnp.asarray(use),
            sharding=mesh.batch_sharding(1), interpret=True))

    take_stores, take_want = {}, {}
    for n in TAKE_N:
        host = JaxImageStore(
            images=np.random.default_rng(n).integers(0, 256, (n, 16, 16, 3),
                                                     np.uint8),
            labels=(np.arange(n) % 2).astype(np.int32), size=16)
        dev = JaxDeviceStore(host, mesh, shard=True)
        t_idx = np.array([0, n - 1, 7, n - 1, 3, 12, 1, 0], np.int32)
        take_want[n] = (np.asarray(jax.jit(dev.take)(dev.images,
                                                     jnp.asarray(t_idx))),
                        len(dev), dev.images.shape[0])
        take_stores[f"n{n}"] = (torch.from_numpy(host.images),
                                torch.from_numpy(t_idx.astype(np.int64)))

    model = port_resnet(params, stats)
    t = torch.from_numpy
    inputs = {"classifier": {
        "real": t(real), "real_labels": t(real_labels),
        "synth": t(synth), "synth_labels": t(synth_labels),
        "model": model.state_dict(), "stages": STAGES, "lr": LR,
        "ratio": RATIO, "use_synth": use_synth, "pick": pick, "flip": flip,
        "mask": t(mask), "runs": {n: r for n, r in RUNS.items()}},
        "take": take_stores}
    # the two modes index the stores differently: one worker input each
    ranks = {}
    for mode in ("concat", "mix"):
        inp = {k: dict(v) if k == "classifier" else v
               for k, v in inputs.items()}
        inp["classifier"]["idx"] = t(idx[mode].astype(np.int64))
        inp["classifier"]["runs"] = {n: r for n, r in RUNS.items()
                                     if r[0] == mode}
        if mode == "mix":
            del inp["take"]
        out = run_cases(inp, tmp_path_factory.mktemp(f"dist_{mode}"))
        ranks.update({n: [r[n] for r in out["classifier"]]
                      for n in inp["classifier"]["runs"]})
        if "take" in out:
            ranks["take"] = out["take"]
    return {"want": want, "gathers": gathers, "ranks": ranks,
            "take_want": take_want, "mask": mask}


@pytest.mark.parametrize("name", ["concat", "mix", "mix_tail"])
def test_two_rank_step_matches_the_jax_mesh_step(clf_run, name):
    losses, state = clf_run["want"][name]
    w = clf_run["mask"] if RUNS[name][2] else np.ones(B, np.float32)
    ref = float(np.sum(losses * w) / w.sum())
    fc = state.params["fc"]
    want_stats = _running_stats(state.batch_stats)
    for r in clf_run["ranks"][name]:
        got = float((r["losses"].numpy() * w).sum() / w.sum())
        assert abs(got - ref) <= 1e-5 * abs(ref), (got, ref)
        valid = w > 0  # padded rows leave every use of the losses
        np.testing.assert_allclose(r["losses"].numpy()[valid], losses[valid],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r["model"]["fc.weight"].numpy(),
                                   np.asarray(fc["kernel"]).T, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(r["model"]["fc.bias"].numpy(),
                                   np.asarray(fc["bias"]), rtol=0, atol=1e-4)
        for k, v in want_stats.items():
            np.testing.assert_allclose(r["model"][k].numpy(), v, rtol=0,
                                       atol=1e-4, err_msg=k)


@pytest.mark.parametrize("mode", ["concat", "mix"])
def test_rank_rows_equal_mixed_gather_spmd(clf_run, mode):
    want = clf_run["gathers"][mode]
    for rank, r in enumerate(clf_run["ranks"][mode]):
        rows = slice(rank * B // 2, (rank + 1) * B // 2)
        np.testing.assert_array_equal(r["rows_u8"].numpy(), want[rows])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_ranks_stay_bitwise_equal(clf_run, name):
    r0, r1 = clf_run["ranks"][name]
    for k in ("losses", "preds", "labels"):
        assert torch.equal(r0[k], r1[k]), k
    for k, v in r0["model"].items():
        assert torch.equal(v, r1["model"][k]), k


@pytest.mark.parametrize("mode", ["concat", "mix"])
def test_sharded_store_step_equals_replicated(clf_run, mode):
    for rep, sh in zip(clf_run["ranks"][mode],
                       clf_run["ranks"][f"{mode}_sharded"]):
        assert torch.equal(rep["rows_u8"], sh["rows_u8"])
        for k in ("losses", "preds", "labels"):
            assert torch.equal(rep[k], sh[k]), k
        for k, v in rep["model"].items():
            assert torch.equal(v, sh["model"][k]), k


@pytest.mark.parametrize("n", TAKE_N)
def test_sharded_take_equals_make_sharded_take(clf_run, n):
    want, want_len, padded = clf_run["take_want"][n]
    for rank, r in enumerate(clf_run["ranks"]["take"]):
        got = r[f"n{n}"]
        assert got["sharded"] and got["len"] == want_len == n
        assert got["held"] == padded // 2 == -(-n // 2)
        np.testing.assert_array_equal(got["rows"].numpy(), want)
        np.testing.assert_array_equal(got["mine"].numpy(),
                                      want[rank * 4:(rank + 1) * 4])
