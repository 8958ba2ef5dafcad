"""xgan_torch's classifier path against the JAX package's.

- The batch sources (``mix_batch``, ``gather_concat``) fed the draws JAX
  made give bitwise the same images and labels.
- One train step in mix mode (frozen base, ``--unfreeze``, and a masked
  tail batch) matches ``xgan.train.classifier.make_train_step`` from the
  same weights and draws: the loss within 1e-5 relative, the updated
  ``fc`` and the BN running statistics within 1e-4 (f32, stages
  (1,1,1,1), 32 px, batch 8).
- ``kfold_splits`` equals sklearn's ``KFold(shuffle=True,
  random_state=42)``; the metrics equal sklearn's to 1e-12.
- The CLI trains the three strategies and the empty-synthetic fallback on
  the fixture with ``--cpu`` and writes the reference JSON schemas and
  torchvision-layout checkpoints.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.metrics import (accuracy_score, precision_recall_fscore_support,
                             roc_auc_score)
from sklearn.model_selection import KFold

from tests.test_torch_port_resnet import (_running_stats, jax_resnet,
                                         port_resnet)
from xgan.data.mixer import mix_batch as jax_mix_batch
from xgan.train.classifier import classifier_optimizer as jax_optimizer
from xgan.train.classifier import gather_concat as jax_gather_concat
from xgan.train.classifier import make_train_step
from xgan.train.common import ModelState
from xgan_torch import kernels
from xgan_torch.cli import train_classifier as cli
from xgan_torch.data.mixer import mix_batch
from xgan_torch.data.pipeline import DeviceStore
from xgan_torch.data.store import ImageStore
from xgan_torch.models.resnet import ResNet50
from xgan_torch.native.png import decode_png
from xgan_torch.train.classifier import (accuracy, auroc,
                                         classifier_optimizer,
                                         gather_concat, train_step,
                                         weighted_prf)
from xgan_torch.train.classifier_loop import kfold_splits

torch.set_num_threads(1)

SIZE, B, NR, NS = 32, 8, 12, 5
STAGES = (1, 1, 1, 1)


def _stores(seed=0):
    rng = np.random.default_rng(seed)
    real = rng.integers(0, 255, (NR, SIZE, SIZE, 3), np.uint8)
    synth = rng.integers(0, 255, (NS, SIZE, SIZE, 3), np.uint8)
    real_labels = (np.arange(NR) % 2).astype(np.int32)
    synth_labels = np.ones(NS, np.int32)
    return real, real_labels, synth, synth_labels


def _device_store(images, labels):
    return DeviceStore(ImageStore(images, labels, SIZE), "cpu")


def _mix_draws(key, ratio, n_pool, b=B):
    """The mixer's draws as xgan.data.mixer.mix_batch makes them for a
    batch of ``b``."""
    k_mask, k_pick = jax.random.split(key)
    use_synth = np.array(jax.random.uniform(k_mask, (b,)) < ratio)
    pick = np.array(jax.random.randint(k_pick, (b,), 0, n_pool), np.int64)
    return torch.from_numpy(use_synth), torch.from_numpy(pick)


@pytest.mark.parametrize("pooled", [False, True])
def test_mix_batch_matches_jax(pooled):
    real, real_labels, synth, synth_labels = _stores()
    idx = np.array([0, 3, 5, 11, 2, 2, 7, 9], np.int32)
    pool = np.array([1, 3, 5, 7, 9], np.int32) if pooled else None
    if pooled:  # the fallback aliases the synthetic store to the real one
        synth, synth_labels = real, real_labels
    key = jax.random.key(7)
    images, labels = jax_mix_batch(
        jnp.asarray(real), jnp.asarray(real_labels), jnp.asarray(idx),
        jnp.asarray(synth), jnp.asarray(synth_labels), jnp.float32(0.5), key,
        synth_pool=None if pool is None else jnp.asarray(pool))
    use_synth, pick = _mix_draws(key, 0.5, len(pool) if pooled else NS)
    assert 0 < int(use_synth.sum()) < B
    t = torch.from_numpy
    got_images, got_labels = mix_batch(
        t(real), t(real_labels.astype(np.int64)), t(idx.astype(np.int64)),
        t(synth), t(synth_labels.astype(np.int64)), 0.5,
        synth_pool=None if pool is None else t(pool.astype(np.int64)),
        use_synth=use_synth, synth_pick=pick)
    np.testing.assert_array_equal(got_images.numpy(), np.asarray(images))
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))


def test_gather_concat_matches_jax():
    real, real_labels, synth, synth_labels = _stores(1)
    idx = np.array([0, 12, 16, 3, 13, 11, 15, 1], np.int32)
    images, labels = jax_gather_concat(
        jnp.asarray(real), jnp.asarray(real_labels), jnp.asarray(synth),
        jnp.asarray(synth_labels), jnp.asarray(idx))
    t = torch.from_numpy
    got_images, got_labels = gather_concat(
        t(real), t(real_labels.astype(np.int64)), t(synth),
        t(synth_labels.astype(np.int64)), t(idx.astype(np.int64)),
        n_real=NR)
    np.testing.assert_array_equal(got_images.numpy(), np.asarray(images))
    np.testing.assert_array_equal(got_labels.numpy(), np.asarray(labels))


def _running(model):
    return {k: v.numpy() for k, v in model.state_dict().items()
            if "running" in k}


@pytest.mark.parametrize("freeze,masked", [(True, False), (False, False),
                                           (True, True)])
def test_train_step_matches_jax(freeze, masked):
    fmodel, params, stats = jax_resnet(seed=2)
    real, real_labels, synth, synth_labels = _stores(2)
    idx = np.array([4, 0, 9, 1, 7, 3, 10, 6], np.int32)
    mask = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32) if masked \
        else None
    ratio, lr = 0.5, 1e-3
    key = jax.random.key(11)

    tx = jax_optimizer(lr, freeze_base=freeze)
    state = ModelState(params=params, batch_stats=stats,
                       opt_state=tx.init(params))
    step = make_train_step(fmodel, tx, mode="mix", jit_compile=False)
    new_state, losses, _, _ = step(
        state, jnp.asarray(real), jnp.asarray(real_labels),
        jnp.asarray(synth), jnp.asarray(synth_labels), jnp.asarray(idx),
        jnp.float32(ratio), key,
        mask=None if mask is None else jnp.asarray(mask))
    k_mix, k_flip = jax.random.split(key)
    use_synth, pick = _mix_draws(k_mix, ratio, NS)
    flip = torch.from_numpy(np.array(
        jax.random.bernoulli(k_flip, 0.5, (B,))))

    model = port_resnet(params, stats)
    opt = classifier_optimizer(model, lr, freeze_base=freeze)
    assert freeze == (sum(p.requires_grad for p in model.parameters()) == 2)
    kernels.reset_launch_counts()
    got, _, _ = train_step(
        model, opt, _device_store(real, real_labels),
        _device_store(synth, synth_labels),
        torch.from_numpy(idx.astype(np.int64)), mode="mix", ratio=ratio,
        mask=None if mask is None else torch.from_numpy(mask), flip=flip,
        use_synth=use_synth, synth_pick=pick)
    assert kernels.LAUNCHES["mixed_gather"] == 0  # CPU: the plain version

    w = np.ones(B, np.float32) if mask is None else mask
    ref_loss = float(np.sum(np.asarray(losses) * w) / w.sum())
    got_loss = float((got.numpy() * w).sum() / w.sum())
    assert abs(got_loss - ref_loss) <= 1e-5 * abs(ref_loss), \
        (got_loss, ref_loss)
    fc = new_state.params["fc"]
    np.testing.assert_allclose(model.fc.weight.detach().numpy(),
                               np.asarray(fc["kernel"]).T, rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(model.fc.bias.detach().numpy(),
                               np.asarray(fc["bias"]), rtol=0, atol=1e-4)
    moved = np.abs(model.fc.bias.detach().numpy()
                   - np.asarray(params["fc"]["bias"])).max()
    assert moved > 5e-4  # the step did update fc (Adam's first step ~lr)
    want, ours = _running_stats(new_state.batch_stats), _running(model)
    for k, v in want.items():
        np.testing.assert_allclose(ours[k], v, rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("n,k", [(24, 5), (100, 3), (10, 2), (7, 7),
                                 (26684, 5)])
def test_kfold_splits_match_sklearn(n, k):
    ours = kfold_splits(n, k)
    theirs = list(KFold(n_splits=k, shuffle=True,
                        random_state=42).split(range(n)))
    assert len(ours) == len(theirs) == k
    for (tr, te), (str_, ste) in zip(ours, theirs):
        np.testing.assert_array_equal(tr, str_)
        np.testing.assert_array_equal(te, ste)


@pytest.mark.parametrize("seed", range(4))
def test_metrics_match_sklearn(seed):
    rng = np.random.default_rng(seed)
    n = 37
    labels = rng.integers(0, 2, n)
    preds = rng.integers(0, 2, n)
    if seed == 1:
        preds[:] = 1  # a class never predicted: zero_division
    if seed == 2:
        labels[:] = 0  # a class only predicted: zero support
    scores = np.round(rng.random(n), 1)  # ties
    want = precision_recall_fscore_support(labels, preds,
                                           average="weighted",
                                           zero_division=0)[:3]
    np.testing.assert_allclose(weighted_prf(labels, preds), want, rtol=0,
                               atol=1e-12)
    assert abs(accuracy(labels, preds)
               - accuracy_score(labels, preds)) <= 1e-12
    if seed == 2:
        assert auroc(labels, scores) == 0.5  # single class
    else:
        assert abs(auroc(labels, scores)
                   - roc_auc_score(labels, scores)) <= 1e-12


# ---- the CLI on the fixture ------------------------------------------------

HISTORY_KEYS = {"epoch", "train_loss", "train_acc", "val_loss", "val_acc",
                "synthetic_ratio"}
METRIC_KEYS = {"loss", "accuracy", "weighted_precision", "weighted_recall",
               "weighted_f1_score"}


def _run_cli(tmp_path, fake_dataset, *extra):
    out = tmp_path / "out"
    argv = ["--cpu", "--data-dir", fake_dataset["data_dir"],
            "--model-dir", str(out / "models"),
            "--results-dir", str(out / "metrics"),
            "--figures-dir", str(out / "figures"),
            "--cache-dir", str(out / "cache"), "--image-size", str(SIZE),
            "--batch-size", "8", "--epochs", "2",
            "--resnet-stages", "1,1,1,1", *extra]
    kernels.reset_launch_counts()
    result = cli.main(argv)
    assert kernels.LAUNCHES["mixed_gather"] == 0
    return result, out


def _check_checkpoints(models_dir, names):
    assert sorted(os.listdir(models_dir)) == sorted(names)
    for name in names:
        model = ResNet50(2, stage_sizes=STAGES)
        model.load_state_dict(torch.load(os.path.join(models_dir, name),
                                         weights_only=True), strict=True)


def _check_figures(figures_dir, strategy, *, cv):
    """The JAX trainer's figures (xgan/io_/figures_classifier.py): the
    curves of every run (a ratio series is in every history), the CV bar
    charts of a CV run; each decodes."""
    kinds = ["loss_curve", "accuracy_curve", "synthetic_ratio_curve"]
    if cv:
        kinds += ["cv_test_metrics_per_fold", "cv_test_loss_per_fold"]
    names = sorted(f"{strategy}_{k}.png" for k in kinds)
    assert sorted(os.listdir(figures_dir)) == names
    for name in names:
        assert decode_png(str(figures_dir / name)).std() > 0


@pytest.mark.parametrize("strategy,extra", [
    ("baseline", ()),
    ("augmented", ("--use-synthetic",)),
    ("curriculum", ("--use-synthetic", "--use-curriculum",
                    "--curriculum-schedule", "0:0.25,1:0.5")),
])
def test_cli_cv_strategies(tmp_path, fake_dataset, strategy, extra):
    summary, out = _run_cli(tmp_path, fake_dataset, "--k-folds", "2",
                            "--synthetic-dir",
                            fake_dataset["synthetic_dir"], *extra)
    metrics = out / "metrics"
    for fold in (1, 2):
        hist = json.loads((metrics / f"fold_{fold}_{strategy}_training_"
                           "history.json").read_text())
        assert set(hist) == HISTORY_KEYS
        assert hist["epoch"] == [1, 2]
        assert np.isfinite(hist["train_loss"]).all()
        want_ratio = {"baseline": [0.0, 0.0], "augmented": [1.0, 1.0],
                      "curriculum": [0.25, 0.5]}[strategy]
        assert hist["synthetic_ratio"] == want_ratio
    saved = json.loads((metrics / f"{strategy}_cv_summary.json").read_text())
    assert set(saved) == {"folds", "average", "std_dev"}
    assert METRIC_KEYS <= set(saved["average"]) == set(saved["folds"][0])
    assert summary["average"] == saved["average"]
    ckpts = [n for n in os.listdir(out / "models")]
    assert ckpts and all(n.endswith(f"{strategy}_resnet50.pth")
                         for n in ckpts)
    _check_checkpoints(out / "models", ckpts)
    _check_figures(out / "figures", strategy, cv=True)


@pytest.mark.parametrize("curriculum", [False, True])
def test_cli_empty_synthetic_dir(tmp_path, fake_dataset, capsys,
                                 curriculum):
    empty = tmp_path / "empty"
    empty.mkdir()
    extra = ("--use-curriculum", "--curriculum-schedule", "0:0.5") \
        if curriculum else ()
    metrics, out = _run_cli(tmp_path, fake_dataset, "--k-folds", "1",
                            "--use-synthetic", "--synthetic-dir",
                            str(empty), *extra)
    text = capsys.readouterr().out
    assert "Warning: Synthetic dataset is empty or None." in text
    assert ("Curriculum fallback" in text) == curriculum
    strategy = "curriculum" if curriculum else "augmented"
    final = json.loads((out / "metrics" / f"{strategy}_final_metrics."
                        "json").read_text())
    assert set(final) == {"config", "metrics"}
    assert METRIC_KEYS <= set(final["metrics"])
    assert final["metrics"] == metrics
    _check_checkpoints(out / "models", [f"{strategy}_resnet50.pth"])
    _check_figures(out / "figures", strategy, cv=False)


def test_cli_errors(tmp_path, fake_dataset, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error")
    for argv in (["--data-dir", fake_dataset["data_dir"]],
                 ["--cpu", "--shard-store"]):
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 1
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert last.startswith("Error:"), last
    assert cli.main(["--cpu", "--data-dir", str(tmp_path / "none"),
                     "--model-dir", str(tmp_path / "m"),
                     "--results-dir", str(tmp_path / "r"),
                     "--figures-dir", str(tmp_path / "f")]) is None
    assert "Dataset not found" in capsys.readouterr().out


@pytest.mark.parametrize("flag", [["--grad-accum", "2"], ["--remat"],
                                  ["--remat-scope", "stage"],
                                  ["--resume-from", "auto"],
                                  ["--trace-dir", "t"],
                                  ["--parallel-folds"]])
def test_cli_ported_loop_flags_are_accepted(flag, tmp_path, capsys):
    """The loop flags the port now supports parse and pass the refusal:
    the run goes on to the dataset check."""
    assert cli.main(["--cpu", *flag, "--data-dir", str(tmp_path / "none"),
                     "--model-dir", str(tmp_path / "m"),
                     "--results-dir", str(tmp_path / "r"),
                     "--figures-dir", str(tmp_path / "f")]) is None
    out = capsys.readouterr().out
    assert "Dataset not found" in out and "not supported" not in out
