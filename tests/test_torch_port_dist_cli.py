"""The port's DCGAN and classifier CLIs under a ``torchrun``-style launch
environment with ``--cpu`` (gloo), against the same CLI in one process.

- The DCGAN CLI (2 epochs of a full batch of 16 and a masked tail of 8
  valid rows, so rank 1's tail rows are all padding) on 2 ranks, with
  and without ``--shard-store``, and on 1 launched rank with it: the
  history JSON within tests/test_sharding.py's metric tolerances (rtol
  2e-4, atol 2e-5) of the one-process run, the same files written, and
  only rank 0 saying it wrote them.
- The classifier CLI (augmented strategy, 2 folds x 1 epoch) on 2 ranks,
  with and without ``--shard-store``: every history, the CV summary and
  the best checkpoints within 1e-4 of the one-process run, the same
  files, only rank 0 writing.
- A 2-rank DCGAN run with ZeRO-1 (``--shard-opt-state``) whose rank 1
  gets SIGTERM after its first epoch: both ranks stop at the same
  boundary (exit 0, the notice), and ``--resume-from auto`` ends bitwise
  equal to a straight 2-rank run with replicated Adam.
- The WGAN-GP and CGAN trainers, ``--grad-accum`` (DCGAN and classifier)
  and ``--remat`` on 2 ranks against one process: the history, the files
  and the ``.pth`` checkpoints.
- The flags a launch once refused: the three GAN trainers at
  ``--steps-per-call 2`` with ``--shard-opt-state``, and the classifier
  with ``--parallel-folds`` (a fold a rank), on 2 ranks against one
  process.
- Tensor parallelism: the DCGAN CLI (with ``--ema-decay``), the
  classifier CLI, the WGAN-GP CLI (``--critic-iters 2``) and the CGAN
  CLI at ``--model-parallel 2`` on 2 ranks (data 1 x model 2; the width
  rule at 8 features, so that the fixture's nets have wide layers)
  against one process: the same files, the DCGAN history within rtol
  2e-4, atol 2e-5, the WGAN-GP's and CGAN's first step within 1e-4 * (1
  + |ref|) and every step within their ``SECOND`` limit, the GANs'
  ``.pth`` files within 3 lr an update, the classifier's JSON and
  checkpoints within 1e-4, only rank 0 writing.
  A TP DCGAN run whose rank 1 gets SIGTERM after its first epoch and is
  resumed with ``--resume-from auto`` ends bitwise equal to the straight
  TP run (the snapshot holds the slices whole, the resume cuts them
  again).
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from tests.torch_port_dist_worker import RANK_TIMEOUT, start_ranks, \
    wait_ranks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
          "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}


def _gan_argv(data_dir, out, epochs, *extra):
    return [sys.executable, "-u", "-m", "xgan_torch.cli.train_gan", "--cpu",
            "--data-dir", data_dir, "--model-dir", f"{out}/models",
            "--output-dir", f"{out}/results",
            "--results-dir", f"{out}/metrics",
            "--figures-dir", f"{out}/figures", "--cache-dir", f"{out}/cache",
            "--image-size", "32", "--feature-maps-g", "8",
            "--feature-maps-d", "8", "--latent-dim", "16",
            "--epochs", str(epochs), "--batch-size", "16",
            "--vis-batch-size", "8", "--save-interval", "2",
            "--checkpoint-interval", "1", *extra]


def _clf_argv(ds, out, *extra):
    return [sys.executable, "-u", "-m", "xgan_torch.cli.train_classifier",
            "--cpu", "--data-dir", ds["data_dir"],
            "--synthetic-dir", ds["synthetic_dir"], "--use-synthetic",
            "--model-dir", f"{out}/models", "--results-dir", f"{out}/metrics",
            "--figures-dir", f"{out}/figures", "--cache-dir", f"{out}/cache",
            "--image-size", "32", "--batch-size", "8", "--epochs", "1",
            "--k-folds", "2", "--resnet-stages", "1,1,1,1", *extra]


def _narrow(argv):
    """``argv`` (a CLI run as ``-m MODULE``) through
    ``tests/torch_port_narrow_zero1.py``: ZeRO-1's rule at 8 features."""
    i = argv.index("-m") + 1
    return argv[:i] + ["tests.torch_port_narrow_zero1"] + argv[i:]


def _one(argv):
    """The CLI in one process without a launch environment."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH}
    env["OMP_NUM_THREADS"] = "1"
    p = subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=RANK_TIMEOUT)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    return p.stdout


def _ranks(argv, world=2):
    outs = wait_ranks(start_ranks(argv, world))
    for rc, text in outs:
        assert rc == 0, text[-4000:]
    return [text for _, text in outs]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if "/cache" not in d and not d.endswith("cache"))


@pytest.fixture(scope="module")
def gan_runs(fake_dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_gan_cli")
    data = fake_dataset["data_dir"]
    runs = {"one": _one(_gan_argv(data, root / "one", 2))}
    for name, world, extra in (("two", 2, []),
                               ("two_sharded", 2, ["--shard-store"]),
                               ("launched_one", 1, ["--shard-store"])):
        runs[name] = _ranks(_gan_argv(data, root / name, 2, *extra), world)
    return root, runs


def _history(root, name):
    return json.loads((root / name / "metrics"
                       / "gan_training_history.json").read_text())


@pytest.mark.parametrize("name", ["two", "two_sharded", "launched_one"])
def test_gan_cli_ranks_match_one_process(gan_runs, name):
    root, runs = gan_runs
    want, got = _history(root, "one"), _history(root, name)
    assert got.keys() == want.keys()
    assert len(got["G_losses_iter"]) == 4
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)
    assert _files(root / name) == _files(root / "one")
    ranks = runs[name]
    assert "Saved final models" in ranks[0]
    assert "Epoch 2/2 Summary" in ranks[-1]
    for text in ranks[1:]:
        assert "Saved" not in text, text[-2000:]
    if name != "launched_one":
        assert "rank 1 of 2" in ranks[1]


@pytest.fixture(scope="module")
def clf_runs(fake_dataset, tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_clf_cli")
    runs = {"one": _one(_clf_argv(fake_dataset, root / "one"))}
    for name, extra in (("two", []), ("two_sharded", ["--shard-store"])):
        runs[name] = _ranks(_clf_argv(fake_dataset, root / name, *extra))
    return root, runs


@pytest.mark.parametrize("name", ["two", "two_sharded"])
def test_classifier_cli_ranks_match_one_process(clf_runs, name):
    root, runs = clf_runs
    files = _files(root / "one")
    assert _files(root / name) == files
    for f in files:
        if f.endswith(".json"):
            want = json.loads((root / "one" / f).read_text())
            got = json.loads((root / name / f).read_text())
            assert got.keys() == want.keys(), f
            for k in want:
                np.testing.assert_allclose(_flat(got[k]), _flat(want[k]),
                                           rtol=0, atol=1e-4,
                                           err_msg=f"{f}:{k}")
        elif f.endswith(".pth"):
            want = torch.load(root / "one" / f, weights_only=True)
            got = torch.load(root / name / f, weights_only=True)
            for k, v in want.items():
                torch.testing.assert_close(got[k].double(), v.double(),
                                           rtol=0, atol=1e-4)
    assert "===== Cross-Validation Summary =====" in runs[name][0]
    assert "Saved best model" in runs[name][0]
    assert "Saved best model" not in runs[name][1]


def _flat(v):
    """The numbers of a JSON value, in order."""
    if isinstance(v, dict):
        return [x for k in sorted(v) for x in _flat(v[k])]
    if isinstance(v, list):
        return [x for e in v for x in _flat(e)]
    return [float(v)]


def test_sigterm_to_one_rank_stops_both_and_resumes(fake_dataset, tmp_path):
    data, epochs = fake_dataset["data_dir"], 12
    straight = _ranks(_gan_argv(data, tmp_path / "straight", epochs))
    assert "Training finished" in straight[0]
    # the stopped and resumed runs keep ZeRO-1 moments: the snapshot
    # holds them whole and the resume cuts them again, bitwise the
    # straight replicated run
    argv = _narrow(_gan_argv(data, tmp_path / "stopped", epochs,
                             "--shard-opt-state"))
    paths = [tmp_path / f"rank{r}.log" for r in range(2)]
    logs = [open(p, "w") for p in paths]
    procs = start_ranks(argv, 2, logs)
    try:
        deadline = time.time() + RANK_TIMEOUT
        while f"Epoch 1/{epochs} Summary" not in paths[1].read_text():
            if time.time() > deadline or procs[1].poll() is not None:
                pytest.fail("rank 1 never finished its first epoch")
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [p.read_text() for p in paths]
    assert rcs == [0, 0], texts
    assert "Received signal" in texts[1], texts[1]
    stops = [ln for t in texts for ln in t.splitlines()
             if ln.startswith("Preempted: training stopped after epoch")]
    assert len(stops) == 2 and stops[0] == stops[1], stops
    stopped = int(stops[0].split("epoch ")[1].split()[0])
    assert 1 <= stopped < epochs
    out = tmp_path / "stopped"
    assert (out / "models/gan/snapshot_last.pth").exists()
    assert not (out / "models/gan/generator_final.pth").exists()

    resumed = _ranks(argv + ["--resume-from", "auto"])
    for text in resumed:
        assert f"at epoch {stopped}, iter {2 * stopped}" in text, text
    a = json.loads((tmp_path / "straight/metrics/gan_training_history.json")
                   .read_text())
    b = json.loads((out / "metrics/gan_training_history.json").read_text())
    assert a == b
    for f in ("generator_final.pth", "discriminator_final.pth"):
        want = torch.load(tmp_path / "straight/models/gan" / f,
                          weights_only=True)
        got = torch.load(out / "models/gan" / f, weights_only=True)
        for k, v in want.items():
            assert torch.equal(got[k], v), (f, k)


def _family_argv(module, data_dir, out, *extra):
    """The WGAN-GP or CGAN trainer at the DCGAN command's size, 1 epoch
    (a full batch of 16, then the masked tail: rank 1's rows all
    padding)."""
    argv = _gan_argv(data_dir, out, 1, *extra)
    argv[argv.index("xgan_torch.cli.train_gan")] = f"xgan_torch.cli.{module}"
    return argv


# the runs a launch refused until they ran across ranks: name -> (the
# argv builder, its history JSON under metrics/)
LAUNCHED = {
    "train_wggan": (lambda ds, out: _family_argv(
        "train_wggan", ds["data_dir"], out, "--critic-iters", "2"),
        "wgan_training_history.json"),
    "train_cgan": (lambda ds, out: _family_argv(
        "train_cgan", ds["data_dir"], out), "cgan_training_history.json"),
    "train_gan--grad-accum": (lambda ds, out: _gan_argv(
        ds["data_dir"], out, 1, "--grad-accum", "2"),
        "gan_training_history.json"),
    "train_classifier--grad-accum": (lambda ds, out: _clf_argv(
        ds, out, "--k-folds", "1", "--grad-accum", "2"),
        "augmented_training_history.json"),
    "train_classifier--remat": (lambda ds, out: _clf_argv(
        ds, out, "--k-folds", "1", "--remat"),
        "augmented_training_history.json"),
}


# the second step's limit, worst |a - b| / (1 + |b|) of a history entry:
# 5e-2 (chip_smoke.py's ``phase_dp_cli`` for the DCGAN CLI's later
# steps), the CGAN's re-derived from its measured floor (see below)
SECOND = {"train_cgan": 1e-4}


def _held_against_one_process(fake_dataset, tmp_path, argv, history,
                              clf: bool, updates: int, second: float):
    """The CLI of ``argv`` on 2 ranks against one process: the same
    files; the classifier's JSON files within 1e-4, as above; a GAN
    history's first step at tests/test_sharding.py's metric tolerances
    (rtol 2e-4, atol 2e-5) and every entry within ``second`` * (1 +
    |ref|); every ``.pth`` within 3 lr an Adam step (``updates``, the
    GANs) or 1e-4 (the classifier). Returns the ranks' outputs."""
    one = _one(argv(fake_dataset, tmp_path / "one"))
    ranks = _ranks(argv(fake_dataset, tmp_path / "two"))
    assert _files(tmp_path / "two") == _files(tmp_path / "one")
    want = json.loads((tmp_path / "one" / "metrics" / history).read_text())
    got = json.loads((tmp_path / "two" / "metrics" / history).read_text())
    assert got.keys() == want.keys()
    worst = 0.0
    for k in want:
        a, b = np.asarray(_flat(got[k])), np.asarray(_flat(want[k]))
        if clf:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=k)
            continue
        # the first step of a per-step series (none of an epoch mean),
        # then every entry
        steps = len(want["G_losses_iter" if "G_losses_iter" in want
                         else "G_losses"])
        first = len(b) // steps
        np.testing.assert_allclose(a[:first], b[:first], rtol=2e-4,
                                   atol=2e-5, err_msg=k)
        worst = max(worst, float(np.max(np.abs(a - b) / (1 + np.abs(b)))))
    assert worst <= second, worst
    for f in _files(tmp_path / "one"):
        if not f.endswith(".pth") or "snapshot" in f:
            continue
        a = torch.load(tmp_path / "two" / f, weights_only=True)
        b = torch.load(tmp_path / "one" / f, weights_only=True)
        for k, v in b.items():
            torch.testing.assert_close(
                a[k].double(), v.double(), rtol=0,
                atol=1e-4 if clf else 3 * 2e-4 * updates, msg=f"{f}:{k}")
    assert "rank 0 of 1" in one and "rank 1 of 2" in ranks[1]
    assert "Saved" not in ranks[1], ranks[1][-2000:]
    return ranks


@pytest.mark.parametrize("name", list(LAUNCHED))
def test_launch_runs_what_it_refused(fake_dataset, tmp_path, name):
    """The WGAN-GP and CGAN trainers, ``--grad-accum`` and ``--remat`` on
    2 ranks against one process (``_held_against_one_process``), 2 GAN
    steps of ``--critic-iters`` (or 1) updates.

    Why the second step is not held as close as the first: it starts
    from parameters that Adam moved by up to lr where a gradient is
    rounding noise (1.33 lr at a coordinate's second step), 5e-2 as
    chip_smoke.py holds the DCGAN CLI's later steps. The CGAN's is 1e-4:
    with the ranks' BN moments combined by Chan's formula (C10 fixed) its
    steps part from one process by 1.4e-5, where the ranks' former
    one-pass variance parted by 5.6e-5 at the first step and 2e-3 at the
    second."""
    argv, history = LAUNCHED[name]
    _held_against_one_process(
        fake_dataset, tmp_path, argv, history,
        name.startswith("train_classifier"),
        2 * (2 if name == "train_wggan" else 1), SECOND.get(name, 5e-2))


def _k2_argv(module, *extra):
    """A GAN trainer at ``--steps-per-call 2`` and ZeRO-1 over the ranks:
    1 epoch of 24 images at B = 10, one K = 2 call then the masked tail
    (4 valid rows, all on rank 0) as one step."""
    def argv(ds, out):
        a = _narrow(_family_argv(module, ds["data_dir"], out,
                                 "--steps-per-call", "2",
                                 "--shard-opt-state", *extra))
        a[a.index("--batch-size") + 1] = "10"
        return a
    return argv


# the flags a launch refused until they ran across ranks: name -> (its
# argv function, its history JSON, the Adam updates of a parameter)
REFUSED = {
    "train_gan--steps-per-call": (_k2_argv("train_gan"),
                                  "gan_training_history.json", 3),
    "train_wggan--steps-per-call": (
        _k2_argv("train_wggan", "--critic-iters", "2"),
        "wgan_training_history.json", 6),
    "train_cgan--steps-per-call": (_k2_argv("train_cgan"),
                                   "cgan_training_history.json", 3),
    "train_classifier--parallel-folds": (
        lambda ds, out: _clf_argv(ds, out, "--parallel-folds",
                                  "--shard-store"),
        "fold_1_augmented_training_history.json", 1),
}


@pytest.mark.parametrize("name", list(REFUSED))
def test_flags_refused_under_a_launch(fake_dataset, tmp_path, name):
    """The flags a launch refused run there: the three GAN trainers at
    ``--steps-per-call 2`` with ZeRO-1 (``--shard-opt-state``), the
    classifier with ``--parallel-folds`` (2 folds, a fold a rank, and
    ``--shard-store``'s note), each on 2 ranks against one process
    (``_held_against_one_process``; the CGAN's later steps at its
    ``SECOND`` limit)."""
    argv, history, updates = REFUSED[name]
    clf = name.startswith("train_classifier")
    module = name.split("--")[0]
    ranks = _held_against_one_process(fake_dataset, tmp_path, argv, history,
                                      clf, updates,
                                      SECOND.get(module, 5e-2))
    if clf:
        assert "Note: --shard-store is ignored with --parallel-folds" \
            in ranks[0]
        assert "rank 1 trains folds 2-2" in ranks[1], ranks[1][-2000:]
        assert "Cross-Validation Summary (parallel folds)" in ranks[0]
    else:
        assert "ZeRO-1: the Adam moments of" in ranks[0]


# name -> (the argv function, the Adam updates of a parameter: the
# GAN's, or 0 for the classifier)
TP_RUNS = {
    "train_gan": (lambda ds, out, *extra: _narrow(_gan_argv(
        ds["data_dir"], out, 2, "--ema-decay", "0.9", *extra)), 4),
    "train_classifier": (lambda ds, out, *extra: _narrow(_clf_argv(
        ds, out, *extra)), 0),
    "train_wggan": (lambda ds, out, *extra: _narrow(_family_argv(
        "train_wggan", ds["data_dir"], out, "--critic-iters", "2", *extra)),
        4),
    "train_cgan": (lambda ds, out, *extra: _narrow(_family_argv(
        "train_cgan", ds["data_dir"], out, *extra)), 2),
}
# the families whose history is held as LAUNCHED's: the first step within
# 1e-4 * (1 + |ref|), every entry within SECOND's limit
TP_FAMILIES = ("train_wggan", "train_cgan")


@pytest.mark.parametrize("name", list(TP_RUNS))
def test_model_parallel_matches_one_process(fake_dataset, tmp_path, name):
    argv, updates = TP_RUNS[name]
    _one(argv(fake_dataset, tmp_path / "one"))
    ranks = _ranks(argv(fake_dataset, tmp_path / "tp", "--model-parallel",
                        "2"))
    assert _files(tmp_path / "tp") == _files(tmp_path / "one")
    for r, text in enumerate(ranks):
        assert (f"Tensor parallelism: mesh {{'data': 1, 'model': 2}}; rank "
                f"{r} is data rank 0, model rank {r}") in text, text[-2000:]
        assert "Error" not in text, text[-2000:]
    assert "Saved" not in ranks[1], ranks[1][-2000:]
    for f in _files(tmp_path / "one"):
        if f.endswith(".json") and name in TP_FAMILIES:
            _family_history_close(tmp_path / "tp" / f, tmp_path / "one" / f,
                                  SECOND.get(name, 5e-2))
        elif f.endswith(".json"):
            want = _flat(json.loads((tmp_path / "one" / f).read_text()))
            got = _flat(json.loads((tmp_path / "tp" / f).read_text()))
            tol = dict(rtol=0, atol=1e-4) if not updates \
                else dict(rtol=2e-4, atol=2e-5)
            np.testing.assert_allclose(got, want, **tol, err_msg=f)
        elif f.endswith(".pth") and "snapshot" not in f:
            want = torch.load(tmp_path / "one" / f, weights_only=True)
            got = torch.load(tmp_path / "tp" / f, weights_only=True)
            assert got.keys() == want.keys(), f
            for k, v in want.items():
                torch.testing.assert_close(
                    got[k].double(), v.double(), rtol=0,
                    atol=3 * 2e-4 * updates if updates else 1e-4,
                    msg=f"{f}:{k}")


def _family_history_close(got_path, want_path, second: float) -> None:
    """A WGAN-GP or CGAN history: each per-step series' first step within
    1e-4 * (1 + |ref|), every entry within ``second`` * (1 + |ref|)."""
    want = json.loads(want_path.read_text())
    got = json.loads(got_path.read_text())
    assert got.keys() == want.keys()
    steps = len(want["G_losses_iter" if "G_losses_iter" in want
                     else "G_losses"])
    worst = 0.0
    for k in want:
        a, b = np.asarray(_flat(got[k])), np.asarray(_flat(want[k]))
        rel = np.abs(a - b) / (1 + np.abs(b))
        first = len(b) // steps  # none of an epoch mean
        assert rel[:first].max(initial=0.0) <= 1e-4, (k, rel[:first])
        worst = max(worst, float(rel.max()))
    assert worst <= second, worst


def test_model_parallel_sigterm_and_resume(fake_dataset, tmp_path):
    epochs = 6
    argv, _ = TP_RUNS["train_gan"]

    def tp_argv(out):
        a = argv(fake_dataset, out, "--model-parallel", "2")
        a[a.index("--epochs") + 1] = str(epochs)
        return a

    straight = _ranks(tp_argv(tmp_path / "straight"))
    assert "Training finished" in straight[0]
    paths = [tmp_path / f"rank{r}.log" for r in range(2)]
    logs = [open(p, "w") for p in paths]
    procs = start_ranks(tp_argv(tmp_path / "stopped"), 2, logs)
    try:
        deadline = time.time() + RANK_TIMEOUT
        while f"Epoch 1/{epochs} Summary" not in paths[1].read_text():
            if time.time() > deadline or procs[1].poll() is not None:
                pytest.fail("rank 1 never finished its first epoch")
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)
        rcs = [p.wait(timeout=RANK_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    texts = [p.read_text() for p in paths]
    assert rcs == [0, 0], texts
    stops = [ln for t in texts for ln in t.splitlines()
             if ln.startswith("Preempted: training stopped after epoch")]
    assert len(stops) == 2 and stops[0] == stops[1], stops
    stopped = int(stops[0].split("epoch ")[1].split()[0])
    assert 1 <= stopped < epochs
    out = tmp_path / "stopped"
    resumed = _ranks(tp_argv(out) + ["--resume-from", "auto"])
    for text in resumed:
        assert f"at epoch {stopped}, iter {2 * stopped}" in text, text
    a = json.loads((tmp_path / "straight/metrics/gan_training_history.json")
                   .read_text())
    b = json.loads((out / "metrics/gan_training_history.json").read_text())
    assert a == b
    for f in ("generator_final.pth", "discriminator_final.pth",
              "generator_ema_final.pth"):
        want = torch.load(tmp_path / "straight/models/gan" / f,
                          weights_only=True)
        got = torch.load(out / "models/gan" / f, weights_only=True)
        for k, v in want.items():
            assert torch.equal(got[k], v), (f, k)
