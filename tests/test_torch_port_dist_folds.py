"""``--parallel-folds`` across two gloo ranks on the CPU
(``tests/torch_port_dist_worker.py``, one launch of two processes): one
lockstep step on the JAX package's fold mesh
(``xgan/train/parallel_folds.py:36-50``) at k = 2 (two fold groups of one
rank: each rank owns a fold) and k = 3 (one group of both ranks: each
rank holds half of every fold's rows), in mix mode with a masked tail in
the second fold, and at k = 3 with ``--grad-accum 2`` on a batch of 10
(two microbatches of 5 rows, split 2 and 3 over the ranks; the second
fold's last row and the third fold's whole second microbatch masked),
from the same weights and draws as

- one process's lockstep step (``lockstep_train_step`` without a group):
  the per-sample losses within 1e-5 (1 + |ref|), the labels equal, every
  fold's ``fc`` and BN running statistics within 1e-4, as
  tests/test_torch_port_parallel_folds.py holds the lockstep step;
- ``make_parallel_steps`` on ``fold_mesh(devices[:2], k)``: each fold's
  mean loss within 1e-5 (1 + |ref|), its ``fc`` and BN statistics within
  1e-4 (tests/test_torch_port_parallel_folds.py's cross-package limits),
  at k = 2 and 3 without accumulation.

Each rank gathers its batch with one fold-batched ``mixed_gather`` call a
step, on exactly its share of the indices (``local_rows(B, A)`` of its
group's folds); the outputs gathered back into (k, B) order
(``FoldLayout.gather``) and every fold's broadcast state dict are the
same on both ranks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from tests.test_torch_port_classifier import _mix_draws
from tests.test_torch_port_resnet import (_running_stats, jax_resnet,
                                         port_resnet)
from tests.torch_port_dist_worker import run_cases
from xgan.train import parallel_folds as jax_pf
from xgan.train.classifier import classifier_optimizer as jax_optimizer
from xgan.train.common import ModelState
from xgan_torch.data.pipeline import DeviceStore
from xgan_torch.data.store import ImageStore
from xgan_torch.train import parallel_folds as pf
from xgan_torch.train.parallel_cv import fold_groups

torch.set_num_threads(1)

SIZE, NR, NS, LR, RATIO = 32, 24, 5, 1e-3, 0.5
# name -> (k folds, batch, --grad-accum)
RUNS = {"k2": (2, 8, 1), "k3": (3, 8, 1), "k3_ga2": (3, 10, 2)}
# fold -> its first masked row. k3_ga2's second fold keeps 4 of its
# second microbatch's 5 rows: with 2 kept, BN at ResNet's 1 x 1 last stage
# takes the statistics of 2 numbers a channel, and one process and two
# ranks (either way of combining their moments) part by 1.1e-4 at a kept
# row and by 1.3 in a masked row's loss of 1.4e3
MASKED = {"k2": {1: 5}, "k3": {1: 5}, "k3_ga2": {1: 9, 2: 5}}


def _jax_step(k, nets, real, real_labels, synth, synth_labels, idx, mask,
              keys, devs, accum):
    """``make_parallel_steps`` on ``fold_mesh(devs, k)``: (per-sample
    losses, labels, each fold's (params, batch_stats))."""
    tx = jax_optimizer(LR, freeze_base=False)
    pmesh = jax_pf.fold_mesh(devs, k)
    stacked = jax_pf.stack_states([ModelState(params=p, batch_stats=s,
                                              opt_state=tx.init(p))
                                   for _, p, s in nets])
    if pmesh.shape["fold"] > 1:
        stacked = jax.device_put(stacked, NamedSharding(pmesh, P("fold")))
    step, _ = jax_pf.make_parallel_steps(nets[0][0], tx, mode="mix",
                                         n_folds=k, pmesh=pmesh,
                                         grad_accum=accum)
    new, losses, _, labels = step(
        stacked, jnp.asarray(real), jnp.asarray(real_labels),
        jnp.asarray(synth), jnp.asarray(synth_labels), jnp.asarray(idx),
        jnp.float32(RATIO), keys, jnp.asarray(mask))
    states = [jax_pf.unstack_state(new, f) for f in range(k)]
    return (np.asarray(losses), np.asarray(labels),
            [(s.params, s.batch_stats) for s in states])


@pytest.fixture(scope="module")
def folds_run(tmp_path_factory):
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs 2 emulated devices")
    rng = np.random.default_rng(80)
    real = rng.integers(0, 255, (NR, SIZE, SIZE, 3), np.uint8)
    synth = rng.integers(0, 255, (NS, SIZE, SIZE, 3), np.uint8)
    real_labels = (np.arange(NR) % 2).astype(np.int32)
    synth_labels = np.ones(NS, np.int32)
    t = torch.from_numpy
    stores = (DeviceStore(ImageStore(real, real_labels, SIZE), "cpu"),
              DeviceStore(ImageStore(synth, synth_labels, SIZE), "cpu"))
    inp = {"real": t(real), "real_labels": t(real_labels), "synth": t(synth),
           "synth_labels": t(synth_labels), "stages": (1, 1, 1, 1),
           "lr": LR, "runs": RUNS, "mix": {}, "models": []}
    want, one = {}, {}
    nets = [jax_resnet(seed=81 + f)
            for f in range(max(k for k, _, _ in RUNS.values()))]
    inp["models"] = [port_resnet(p, s).state_dict() for _, p, s in nets]
    for name, (k, b, accum) in RUNS.items():
        idx = rng.integers(0, NR, (k, b)).astype(np.int32)
        mask = np.ones((k, b), np.float32)
        for f, start in MASKED[name].items():
            mask[f, start:] = 0
        keys = jax.random.split(jax.random.fold_in(jax.random.key(82), k), k)
        if accum == 1:
            want[name] = _jax_step(k, nets[:k], real, real_labels, synth,
                                   synth_labels, idx, mask, keys, devs[:2],
                                   accum)
        draws = {"use_synth": [], "synth_pick": [], "flip": []}
        for f in range(k):
            k_mix, k_flip = jax.random.split(keys[f])
            use_synth, pick = _mix_draws(k_mix, RATIO, NS, b)
            draws["use_synth"].append(use_synth)
            draws["synth_pick"].append(pick)
            draws["flip"].append(t(np.array(
                jax.random.bernoulli(k_flip, 0.5, (b,)))))
        run = {"idx": t(idx.astype(np.int64)), "mask": t(mask),
               "accum": accum,
               **{n: torch.stack(v) for n, v in draws.items()}}
        inp["mix"][name] = run
        # one process, no group
        models = [port_resnet(p, s) for _, p, s in nets[:k]]
        stack = pf.FoldStack(models, [n for n, _ in
                                      models[0].named_parameters()])
        fopt = pf.FoldAdam(stack.trainable, k, LR)
        out = pf.lockstep_train_step(stack, fopt, *stores, run["idx"],
                                     run["mask"], mode="mix", ratio=RATIO,
                                     use_synth=run["use_synth"],
                                     synth_pick=run["synth_pick"],
                                     flip=run["flip"], grad_accum=accum)
        one[name] = (out, [stack.state_dict(f) for f in range(k)])
    ranks = run_cases({"folds": inp}, tmp_path_factory.mktemp("dist_folds"))
    return {"want": want, "one": one, "inp": inp, "ranks": ranks["folds"]}


def _stats_close(sd, params, stats, what):
    np.testing.assert_allclose(sd["fc.weight"].numpy(),
                               np.asarray(params["fc"]["kernel"]).T, rtol=0,
                               atol=1e-4, err_msg=what)
    np.testing.assert_allclose(sd["fc.bias"].numpy(),
                               np.asarray(params["fc"]["bias"]), rtol=0,
                               atol=1e-4, err_msg=what)
    for n, v in _running_stats(stats).items():
        np.testing.assert_allclose(sd[n].numpy(), v, rtol=0, atol=1e-4,
                                   err_msg=(what, n))


def _rank_rows(r: int, n: int, b: int, accum: int) -> np.ndarray:
    """Rank ``r``'s rows of a batch of ``b`` split over ``n`` ranks: its
    share ``[r*mb//n, (r+1)*mb//n)`` of each microbatch of ``mb``."""
    mb = b // accum
    return np.concatenate([np.arange(j * mb + r * mb // n,
                                     j * mb + (r + 1) * mb // n)
                           for j in range(accum)])


@pytest.mark.parametrize("name", list(RUNS))
def test_ranks_own_the_fold_mesh_layout(folds_run, name):
    k, b, accum = RUNS[name]
    groups = fold_groups(k, 2)
    per = k // len(groups)
    for r, out in enumerate(folds_run["ranks"]):
        g = next(i for i, ranks in enumerate(groups) if r in ranks)
        assert tuple(out[name]["folds"]) == (g * per, (g + 1) * per)
        n = len(groups[g])
        losses = out[name]["mine"][0]
        rows = _rank_rows(groups[g].index(r), n, b, accum)
        assert losses.shape == (per, rows.size), losses.shape


@pytest.mark.parametrize("name", list(RUNS))
def test_lockstep_on_two_ranks_matches_one_process(folds_run, name):
    (losses, preds, labels), states = folds_run["one"][name]
    for out in folds_run["ranks"]:
        got = out[name]
        g_losses, g_preds, g_labels = got["every"]
        # NaN where a fold's microbatch is all masked, on both sides
        scale = float(losses.nan_to_num().abs().max())
        np.testing.assert_allclose(g_losses.numpy(), losses.numpy(), rtol=0,
                                   atol=1e-5 * (1 + scale))
        assert torch.equal(g_labels, labels)
        for f, sd in enumerate(states):
            mine = got["states"][f]
            for n, v in sd.items():
                # fc and the BN statistics: an unfrozen base's parameters
                # move by lr either way where a gradient is rounding noise
                if n.startswith("fc.") or "running_" in n:
                    np.testing.assert_allclose(mine[n].numpy(), v.numpy(),
                                               rtol=0, atol=1e-4,
                                               err_msg=(name, f, n))
    a, b = folds_run["ranks"]
    for x, y in zip(a[name]["every"], b[name]["every"]):  # NaN equals NaN
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    for sa, sb in zip(a[name]["states"], b[name]["states"]):
        assert all(torch.equal(v, sb[n]) for n, v in sa.items())


@pytest.mark.parametrize("name", [n for n, (_, _, a) in RUNS.items()
                                  if a == 1])
def test_lockstep_on_two_ranks_matches_the_jax_fold_mesh(folds_run, name):
    losses, labels, states = folds_run["want"][name]
    mask = folds_run["inp"]["mix"][name]["mask"].numpy()
    for out in folds_run["ranks"]:
        g_losses, _, g_labels = out[name]["every"]
        np.testing.assert_array_equal(g_labels.numpy(), labels)
        for f, (params, stats) in enumerate(states):
            w = mask[f]
            ref = float(np.sum(losses[f] * w) / w.sum())
            ours = float((g_losses[f].numpy() * w).sum() / w.sum())
            assert abs(ours - ref) <= 1e-5 * (1 + abs(ref)), (f, ours, ref)
            _stats_close(out[name]["states"][f], params, stats, (name, f))


@pytest.mark.parametrize("name", list(RUNS))
def test_one_fold_batched_gather_a_rank(folds_run, name):
    k, b, accum = RUNS[name]
    idx = folds_run["inp"]["mix"][name]["idx"]
    n = len(fold_groups(k, 2)[0])
    for r, out in enumerate(folds_run["ranks"]):
        calls = out[name]["gathers"]
        lo, hi = out[name]["folds"]
        rows = torch.from_numpy(_rank_rows(r % n, n, b, accum))
        assert len(calls) == 1 and torch.equal(calls[0], idx[lo:hi][:, rows])
