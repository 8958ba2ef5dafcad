"""``--parallel-folds`` of xgan_torch's classifier against its own
sequential fold steps and against ``xgan.train.parallel_folds``.

- ``fold_epoch_batches`` and ``fold_masks`` equal the JAX package's.
- A k-fold stack unstacks to each fold's state dict.
- One lockstep step (``lockstep_train_step``) equals k of the port's own
  sequential ``train_step``s fold by fold, from the same weights, masks
  and draws (f32, stages (1,1,1,1), 32 px, B = 8): the valid rows'
  losses within 1e-5 (1 + |ref|), every gradient norm-wise within 1e-3
  relative plus twice a measured rounding floor (the floor: the same step
  on the batch's rows in another order), BN running statistics and the
  updated ``fc`` within 1e-4; at A = 1 and A = 2 (a fold's fully padded
  microbatch among them), frozen and ``--unfreeze``, with a remat scope,
  with and without padded rows. The lockstep eval step equals
  ``eval_step`` within 1e-5.
- The same step against ``make_parallel_steps`` fed the draws the JAX
  step made from ``split(fold_in(key, step), k)``: each fold's loss
  within 1e-5 (1 + |ref|), ``fc`` and BN statistics within 1e-4, as
  tests/test_torch_port_classifier.py holds one step.
- A fold with an all-zero mask stays bitwise as it was, its Adam step
  count included, while the others move; its next update then equals a
  sequential run that never saw the frozen step (a shared step count
  fails this by ~1e-4).
- The empty-synthetic fallback draws each fold from its own pool.
- The CLI writes the sequential path's file names and JSON keys, composes
  with the loop flags, prints the resume note, and a SIGTERM'd run
  writes no history and no summary.
"""
import copy
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_port_classifier import _mix_draws
from tests.test_torch_port_resnet import (_running_stats, jax_resnet,
                                         port_resnet)
from xgan.train import parallel_folds as jax_pf
from xgan.train.classifier import classifier_optimizer as jax_optimizer
from xgan.train.common import ModelState
from xgan_torch import kernels
from xgan_torch.cli import train_classifier as cli
from xgan_torch.data.mixer import mix_batch
from xgan_torch.data.pipeline import DeviceStore
from xgan_torch.data.store import ImageStore
from xgan_torch.models.resnet import ResNet50
from xgan_torch.train import parallel_cv
from xgan_torch.train import parallel_folds as pf
from xgan_torch.train.classifier import (classifier_optimizer, eval_step,
                                         train_step)
from xgan_torch.train.classifier_loop import kfold_splits

torch.set_num_threads(1)

SIZE, B, NR, NS, K = 32, 8, 24, 5, 3
STAGES = (1, 1, 1, 1)


@pytest.mark.parametrize("sizes,b,shuffle", [
    ([16, 9], 4, True), ([10, 10, 9], 3, True), ([7, 20, 13], 8, False),
    ([5], 8, True)])
def test_fold_batches_and_masks_match_jax(sizes, b, shuffle):
    rng = np.random.default_rng(3)
    spaces = [rng.permutation(40)[:n] for n in sizes]
    ours = pf.fold_epoch_batches(spaces, b, np.random.default_rng(7),
                                 shuffle=shuffle)
    theirs = jax_pf.fold_epoch_batches(spaces, b, np.random.default_rng(7),
                                       shuffle=shuffle)
    for a, t in zip(ours, theirs):
        assert a.dtype == t.dtype
        np.testing.assert_array_equal(a, t)
    masks = pf.fold_masks(ours[0].shape[0], b, ours[1])
    want = jax_pf.fold_masks(ours[0].shape[0], b, ours[1])
    assert masks.dtype == want.dtype
    np.testing.assert_array_equal(masks, want)


def _stores(seed=0):
    rng = np.random.default_rng(seed)
    real = rng.integers(0, 255, (NR, SIZE, SIZE, 3), np.uint8)
    synth = rng.integers(0, 255, (NS, SIZE, SIZE, 3), np.uint8)
    real_labels = (np.arange(NR) % 2).astype(np.int32)
    return (DeviceStore(ImageStore(real, real_labels, SIZE), "cpu"),
            DeviceStore(ImageStore(synth, np.ones(NS, np.int32), SIZE),
                        "cpu"))


def _folds(freeze, scope=None, seed=0):
    """K port ResNets from seeds, a FoldStack and FoldAdam over copies,
    and the sequential models with their Adam."""
    models = [ResNet50(2, stage_sizes=STAGES, remat=scope is not None,
                       remat_scope=scope or "block",
                       generator=torch.Generator().manual_seed(seed + f))
              for f in range(K)]
    seq = [copy.deepcopy(m) for m in models]
    opts = [classifier_optimizer(m, 1e-3, freeze_base=freeze) for m in seq]
    names = [n for n, p in seq[0].named_parameters() if p.requires_grad]
    stack = pf.FoldStack(models, names)
    return stack, pf.FoldAdam(stack.trainable, K, 1e-3), seq, opts, names


def _draws(seed, k=K):
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    return dict(idx=t(rng.integers(0, NR, (k, B))),
                use_synth=t(rng.random((k, B)) < 0.5),
                synth_pick=t(rng.integers(0, NS, (k, B))),
                flip=t(rng.random((k, B)) < 0.5))


def test_stack_unstacks_to_each_fold():
    stack, _, seq, _, _ = _folds(freeze=False)
    for f in range(K):
        sd = stack.state_dict(f)
        assert list(sd) == list(seq[f].state_dict())
        for n, v in seq[f].state_dict().items():
            assert torch.equal(sd[n], v), n
        ResNet50(2, stage_sizes=STAGES).load_state_dict(sd, strict=True)


@pytest.mark.parametrize("freeze,accum,scope,tails", [
    (True, 1, None, True), (False, 1, None, True), (False, 2, None, True),
    (True, 2, None, True), (False, 1, "stage", True),
    (False, 2, "nested", True), (False, 1, None, False),
    (False, 2, "block", False)])
def test_lockstep_step_matches_sequential_steps(freeze, accum, scope, tails):
    """Gradients norm-wise within 1e-3 plus twice the floor that rounding
    sets: the same sequential step on its batch's rows in another order
    within each microbatch, so that every batch reduction sums in another
    order, as the grouped step's do (BN over a few rows makes the
    base's gradients ill-conditioned: the floor reaches 3e-2). With
    ``tails`` two folds have padded rows, and both paths run the masked
    BN; without, every row is valid and both run ``F.batch_norm``, the
    sequential step without a mask, as its loop calls it."""
    real, synth = _stores()
    stack, fopt, seq, opts, names = _folds(freeze, scope)
    floor_seq = [copy.deepcopy(m) for m in seq]
    floor_opts = [classifier_optimizer(m, 1e-3, freeze_base=freeze)
                  for m in floor_seq]
    mb = B // accum  # reversed within each microbatch
    order = torch.arange(B).reshape(accum, mb).flip(1).reshape(-1)
    d = _draws(1)
    mask = torch.ones(K, B)
    if tails:
        mask[1, 7:] = 0  # a tail: every counted microbatch keeps 3+ rows
        mask[2, 4:] = 0  # fold 3's second microbatch: all padding at A = 2
    kernels.reset_launch_counts()
    losses, preds, labels = pf.lockstep_train_step(
        stack, fopt, real, synth, d["idx"], mask, mode="mix", ratio=0.5,
        use_synth=d["use_synth"], synth_pick=d["synth_pick"],
        flip=d["flip"], grad_accum=accum)
    assert kernels.LAUNCHES["mixed_gather"] == 0  # CPU: the plain version
    assert losses.shape == preds.shape == labels.shape == (K, B)
    np.testing.assert_array_equal(fopt.step_count, [1] * K)
    for f in range(K):
        for model, opt, rows in ((seq[f], opts[f], slice(None)),
                                 (floor_seq[f], floor_opts[f], order)):
            ls, _, ys = train_step(
                model, opt, real, synth, d["idx"][f][rows], mode="mix",
                ratio=0.5, mask=mask[f][rows] if tails else None,
                use_synth=d["use_synth"][f][rows],
                synth_pick=d["synth_pick"][f][rows],
                flip=d["flip"][f][rows], grad_accum=accum)
            if model is seq[f]:
                want_losses, want_labels = ls, ys
        valid = mask[f] > 0
        assert torch.equal(want_labels, labels[f])
        assert ((want_losses - losses[f]).abs()[valid]
                <= 1e-5 * (1 + want_losses.abs()[valid])).all(), f
        params = dict(seq[f].named_parameters())
        floor = dict(floor_seq[f].named_parameters())
        for n in names:
            want = params[n].grad
            got = pf.fold_view(stack.params[n].grad, K)[f]
            limit = 1e-3 * want.norm() + 2 * (floor[n].grad - want).norm()
            assert (got - want).norm() <= limit + 1e-12, (f, n)
        ours = stack.state_dict(f)
        for n, v in seq[f].state_dict().items():
            if "running" in n or n.startswith("fc."):
                assert (ours[n] - v).abs().max() <= 1e-4, (f, n)
    v_idx = torch.from_numpy(np.random.default_rng(2).integers(0, NR,
                                                               (K, B)))
    v_losses, v_preds, _, v_prob = pf.lockstep_eval_step(stack, real, v_idx)
    for f in range(K):
        seq[f].load_state_dict(stack.state_dict(f))
        want = eval_step(seq[f], real, v_idx[f])
        assert (want[0] - v_losses[f]).abs().max() <= 1e-5
        assert (want[3] - v_prob[f]).abs().max() <= 1e-5


@pytest.mark.parametrize("freeze", [True, False])
def test_lockstep_step_matches_jax(freeze):
    """One step of ``make_parallel_steps`` (mix mode, k = 2, a masked tail
    in fold 2) and the port's lockstep step from the same weights and
    draws."""
    k, ratio, lr = 2, 0.5, 1e-3
    rng = np.random.default_rng(4)
    real = rng.integers(0, 255, (NR, SIZE, SIZE, 3), np.uint8)
    synth = rng.integers(0, 255, (NS, SIZE, SIZE, 3), np.uint8)
    real_labels = (np.arange(NR) % 2).astype(np.int32)
    synth_labels = np.ones(NS, np.int32)
    idx = rng.integers(0, NR, (k, B)).astype(np.int32)
    mask = np.ones((k, B), np.float32)
    mask[1, 6:] = 0
    tx = jax_optimizer(lr, freeze_base=freeze)
    nets = [jax_resnet(seed=10 + f) for f in range(k)]
    fmodel = nets[0][0]
    stacked = jax_pf.stack_states([ModelState(params=p, batch_stats=s,
                                              opt_state=tx.init(p))
                                   for _, p, s in nets])
    step, _ = jax_pf.make_parallel_steps(fmodel, tx, mode="mix", n_folds=k)
    keys = jax.random.split(jax.random.fold_in(jax.random.key(5), 0), k)
    new, losses, _, labels = step(
        stacked, jnp.asarray(real), jnp.asarray(real_labels),
        jnp.asarray(synth), jnp.asarray(synth_labels), jnp.asarray(idx),
        jnp.float32(ratio), keys, jnp.asarray(mask))
    draws = {"use_synth": [], "synth_pick": [], "flip": []}
    for f in range(k):
        k_mix, k_flip = jax.random.split(keys[f])
        use_synth, pick = _mix_draws(k_mix, ratio, NS)
        draws["use_synth"].append(use_synth)
        draws["synth_pick"].append(pick)
        draws["flip"].append(torch.from_numpy(np.array(
            jax.random.bernoulli(k_flip, 0.5, (B,)))))

    models = [port_resnet(p, s) for _, p, s in nets]
    names = [n for n, _ in models[0].named_parameters()
             if not freeze or n.startswith("fc.")]
    stack = pf.FoldStack(models, names)
    fopt = pf.FoldAdam(stack.trainable, k, lr)
    t = torch.from_numpy
    got, _, got_labels = pf.lockstep_train_step(
        stack, fopt, DeviceStore(ImageStore(real, real_labels, SIZE), "cpu"),
        DeviceStore(ImageStore(synth, synth_labels, SIZE), "cpu"),
        t(idx.astype(np.int64)), t(mask), mode="mix", ratio=ratio,
        **{n: torch.stack(v) for n, v in draws.items()})
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))
    for f in range(k):
        w = mask[f]
        ref = float(np.sum(np.asarray(losses[f]) * w) / w.sum())
        ours = float((got[f].numpy() * w).sum() / w.sum())
        assert abs(ours - ref) <= 1e-5 * (1 + abs(ref)), (f, ours, ref)
        st = jax_pf.unstack_state(new, f)
        sd = stack.state_dict(f)
        np.testing.assert_allclose(sd["fc.weight"].numpy(),
                                   np.asarray(st.params["fc"]["kernel"]).T,
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(sd["fc.bias"].numpy(),
                                   np.asarray(st.params["fc"]["bias"]),
                                   rtol=0, atol=1e-4)
        moved = np.abs(sd["fc.bias"].numpy()
                       - np.asarray(nets[f][1]["fc"]["bias"])).max()
        assert moved > 5e-4
        for n, v in _running_stats(st.batch_stats).items():
            np.testing.assert_allclose(sd[n].numpy(), v, rtol=0, atol=1e-4,
                                       err_msg=(f, n))


@pytest.mark.parametrize("freeze", [True, False])
def test_frozen_fold_is_bitwise_unchanged(freeze):
    real, synth = _stores(1)
    stack, fopt, _, _, _ = _folds(freeze)
    d = [_draws(s) for s in (5, 6)]
    kw = dict(mode="mix", ratio=0.5)

    def run(i, mask):
        return pf.lockstep_train_step(
            stack, fopt, real, synth, d[i]["idx"], mask,
            use_synth=d[i]["use_synth"], synth_pick=d[i]["synth_pick"],
            flip=d[i]["flip"], **kw)

    run(0, torch.ones(K, B))
    held = stack.fold_tensors() + fopt.state_tensors()
    before = [pf.fold_view(t, K).clone() for t in held]
    trained = [pf.fold_view(t, K).clone() for t in stack.trainable]
    mask = torch.ones(K, B)
    mask[1] = 0
    losses, _, _ = run(1, mask)
    for t, b in zip(held, before):
        assert torch.equal(pf.fold_view(t, K)[1], b[1])
    assert not any(torch.equal(pf.fold_view(t, K)[f], b[f]) for f in (0, 2)
                   for t, b in zip(stack.trainable, trained))
    np.testing.assert_array_equal(fopt.step_count, [2, 1, 2])
    assert torch.isfinite(losses[0]).all()


def test_frozen_fold_keeps_its_own_step_count():
    """Fold 2 sits out the second of three lockstep steps; its fc then
    equals two sequential steps on the first and third batches (a step
    count shared by the folds gives it the third step's bias
    correction)."""
    real, synth = _stores(2)
    stack, fopt, seq, opts, _ = _folds(freeze=True)
    d = [_draws(s) for s in (7, 8, 9)]
    for i in range(3):
        mask = torch.ones(K, B)
        if i == 1:
            mask[1] = 0
        pf.lockstep_train_step(
            stack, fopt, real, synth, d[i]["idx"], mask, mode="mix",
            ratio=0.5, use_synth=d[i]["use_synth"],
            synth_pick=d[i]["synth_pick"], flip=d[i]["flip"])
        if i != 1:
            train_step(seq[1], opts[1], real, synth, d[i]["idx"][1],
                       mode="mix", ratio=0.5, mask=torch.ones(B),
                       use_synth=d[i]["use_synth"][1],
                       synth_pick=d[i]["synth_pick"][1],
                       flip=d[i]["flip"][1])
    np.testing.assert_array_equal(fopt.step_count, [3, 2, 3])
    ours = stack.state_dict(1)
    for n, v in seq[1].state_dict().items():
        tol = 1e-6 if n.startswith("fc.") else 1e-4
        assert (ours[n] - v).abs().max() <= tol, n


def test_pooled_fallback_keeps_one_pool_per_fold():
    real, _ = _stores(3)
    splits = kfold_splits(NR, K)
    pools = parallel_cv.fold_pools(real, splits)
    assert pools.shape[0] == K
    for f, (tr, _) in enumerate(splits):
        positives = tr[real.labels_host[tr] == 1]
        assert set(pools[f].tolist()) == set(positives.tolist())
    rng = np.random.default_rng(4)
    idx = torch.from_numpy(rng.integers(0, NR, (K, B)))
    pick = torch.from_numpy(rng.integers(0, pools.shape[1], (K, B)))
    images, labels = mix_batch(real.images, real.labels, idx, real.images,
                               real.labels, 1.0, synth_pool=pools,
                               use_synth=torch.ones(K, B, dtype=torch.bool),
                               synth_pick=pick)
    for f in range(K):
        rows = pools[f][pick[f]]
        assert torch.equal(images[f], real.images[rows])
        assert (labels[f] == 1).all()


# ---- the CLI ---------------------------------------------------------------

def _cli(fake_dataset, out, *extra, epochs=2, synth=None):
    kernels.reset_launch_counts()
    result = cli.main([
        "--cpu", "--data-dir", fake_dataset["data_dir"],
        "--synthetic-dir", synth or fake_dataset["synthetic_dir"],
        "--model-dir", str(out / "models"),
        "--results-dir", str(out / "metrics"),
        "--figures-dir", str(out / "figures"),
        "--cache-dir", str(out / "cache"), "--image-size", str(SIZE),
        "--batch-size", "8", "--epochs", str(epochs), "--k-folds", "2",
        "--resnet-stages", "1,1,1,1", *extra])
    assert kernels.LAUNCHES["mixed_gather"] == 0
    return result


@pytest.mark.parametrize("strategy,extra", [
    ("augmented", ("--use-synthetic",)),
    ("curriculum", ("--use-synthetic", "--use-curriculum",
                    "--curriculum-schedule", "0:0.25,1:0.5"))])
def test_cli_writes_the_sequential_artifacts(tmp_path, fake_dataset,
                                             capsys, strategy, extra):
    seq = _cli(fake_dataset, tmp_path / "seq", *extra)
    par = _cli(fake_dataset, tmp_path / "par", *extra, "--parallel-folds")
    out = capsys.readouterr().out
    assert "[parallel 2-fold" in out and "(parallel folds)" in out
    assert set(par) == set(seq) and set(par["average"]) == \
        set(seq["average"])
    for sub in ("metrics", "models", "figures"):
        assert sorted(os.listdir(tmp_path / "par" / sub)) == \
            sorted(os.listdir(tmp_path / "seq" / sub))
    for name in os.listdir(tmp_path / "par" / "metrics"):
        ours = json.loads((tmp_path / "par" / "metrics" / name).read_text())
        theirs = json.loads((tmp_path / "seq" / "metrics" / name)
                            .read_text())
        assert list(ours) == list(theirs), name
        if "history" in name:
            assert ours["epoch"] == [1, 2]
            assert ours["synthetic_ratio"] == theirs["synthetic_ratio"]
            assert np.isfinite(ours["train_loss"]).all()
    for name in os.listdir(tmp_path / "par" / "models"):
        ResNet50(2, stage_sizes=STAGES).load_state_dict(torch.load(
            tmp_path / "par" / "models" / name, weights_only=True))


@pytest.mark.parametrize("extra", [
    ("--grad-accum", "2", "--unfreeze"),
    ("--remat", "--remat-scope", "stage", "--unfreeze"),
    ("--trace-dir", "TRACE"),
    ("--use-curriculum", "--curriculum-schedule", "0:0.5", "--synthetic-dir",
     "EMPTY")])
def test_cli_composes_with_the_loop_flags(tmp_path, fake_dataset, capsys,
                                          extra):
    extra = [str(tmp_path / a) if a in ("TRACE", "EMPTY") else a
             for a in extra]
    (tmp_path / "EMPTY").mkdir()
    summary = _cli(fake_dataset, tmp_path, "--use-synthetic",
                   "--parallel-folds", "--limit-batches", "2", *extra)
    out = capsys.readouterr().out
    assert summary is not None and np.isfinite(summary["average"]["loss"])
    if "TRACE" in " ".join(extra):
        assert len(os.listdir(tmp_path / "TRACE")) == 1
    if "EMPTY" in " ".join(extra):
        assert out.count("Curriculum fallback") == 2


def test_cli_resume_note(tmp_path, fake_dataset, capsys):
    assert _cli(fake_dataset, tmp_path, "--parallel-folds", "--resume-from",
                "auto", epochs=1) is not None
    out = capsys.readouterr().out
    assert ("Note: --resume-from auto has no effect with --parallel-folds "
            "(folds train in lockstep); training all folds from scratch."
            in out)
    assert "already trained" not in out


def test_sigterm_writes_no_history_and_no_summary(tmp_path, fake_dataset,
                                                  monkeypatch, capfd):
    step = parallel_cv.lockstep_train_step
    sent = []

    def signalled(*a, **k):
        if not sent:  # SIGTERM in the first epoch's first step
            sent.append(os.kill(os.getpid(), signal.SIGTERM))
        return step(*a, **k)
    monkeypatch.setattr(parallel_cv, "lockstep_train_step", signalled)
    assert _cli(fake_dataset, tmp_path, "--parallel-folds") is None
    captured = capfd.readouterr()  # the handler writes to fd 2
    assert "Received signal" in captured.err
    assert "Preempted: parallel 2-fold CV stopped after epoch 1/2" in \
        captured.out
    metrics = tmp_path / "metrics"
    assert not [n for n in os.listdir(metrics) if n.endswith(".json")]
    assert not os.path.exists(tmp_path / "figures") or \
        not os.listdir(tmp_path / "figures")
