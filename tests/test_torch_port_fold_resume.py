"""Fold-level ``--resume-from auto``, preemption and ``--trace-dir`` of
xgan_torch's classifier, mirroring tests/test_fold_resume.py:26,42 and
tests/test_preempt.py:148 for the JAX package.

- A completed fold (history over every epoch, best checkpoint
  ``fold_{N}_{strategy}_resnet50.pth``) is loaded, not retrained, and
  evaluates as before; one whose history is short retrains.
- A fold checkpoint that does not fit the flags is an ``Error:``, never
  a silent retrain; a ``--resume-from`` other than ``auto`` is an
  ``Error:``; on a single run ``auto`` prints its note.
- A fold stopped by SIGTERM/SIGINT (a stand-in whose flag is already
  raised) writes no history and the run no summary; a resume completes
  it. A run stopped after a completed fold resumes to a summary equal to
  a straight run's.
- ``--trace-dir`` writes one trace of one train epoch.
"""
import json

import numpy as np

from xgan_torch.cli import train_classifier as cli
from xgan_torch.train import classifier_loop

import torch

torch.set_num_threads(1)


def _cli(fake_dataset, out, *extra, epochs=2, folds=2):
    return cli.main(["--cpu", "--data-dir", fake_dataset["data_dir"],
                     "--model-dir", str(out / "models"),
                     "--results-dir", str(out / "metrics"),
                     "--figures-dir", str(out / "figures"),
                     "--cache-dir", str(out / "cache"), "--image-size", "32",
                     "--batch-size", "8", "--epochs", str(epochs),
                     "--k-folds", str(folds), "--limit-batches", "1",
                     "--resnet-stages", "1,1,1,1", *extra])


class _Stop:
    """Stand-in for ``GracefulShutdown``: no signal handlers, a flag the
    test raises (deterministic, no signal-timing race)."""

    def __init__(self, requested=False):
        self.requested = requested

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_completed_folds_are_loaded_not_retrained(fake_dataset, tmp_path,
                                                  capsys):
    first = _cli(fake_dataset, tmp_path)
    capsys.readouterr()
    second = _cli(fake_dataset, tmp_path, "--resume-from", "auto")
    out = capsys.readouterr().out
    assert out.count("already trained") == 2
    assert "Train Epoch" not in out and "Saved best model" not in out
    assert second == first


def test_an_incomplete_fold_retrains(fake_dataset, tmp_path, capsys):
    _cli(fake_dataset, tmp_path, epochs=1)
    capsys.readouterr()
    summary = _cli(fake_dataset, tmp_path, "--resume-from", "auto",
                   epochs=2)
    out = capsys.readouterr().out
    assert "already trained" not in out and summary is not None
    hist = json.loads((tmp_path / "metrics" /
                       "fold_1_baseline_training_history.json").read_text())
    assert len(hist["epoch"]) == 2


def test_a_mismatched_fold_checkpoint_is_an_error(fake_dataset, tmp_path,
                                                  capsys):
    _cli(fake_dataset, tmp_path)
    capsys.readouterr()
    assert _cli(fake_dataset, tmp_path, "--resume-from", "auto",
                "--resnet-stages", "1,1,1,2") is None
    out = capsys.readouterr().out
    assert "Error: fold checkpoint" in out and "does not match" in out
    assert "Train Epoch" not in out  # no silent retrain


def test_resume_values_and_the_single_run_note(fake_dataset, tmp_path,
                                               capsys):
    assert _cli(fake_dataset, tmp_path, "--resume-from", "last") is None
    out = capsys.readouterr().out
    assert ("Error: the classifier supports only --resume-from auto "
            "(fold-level resume); got 'last'.") in out
    metrics = _cli(fake_dataset, tmp_path, "--resume-from", "auto",
                   epochs=1, folds=1)
    out = capsys.readouterr().out
    assert "Note: --resume-from auto has no effect on single (non-CV)" in out
    assert np.isfinite(metrics["loss"])


def test_a_stopped_fold_writes_no_history_and_resumes(fake_dataset,
                                                      tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.setattr(classifier_loop, "GracefulShutdown",
                        lambda *a, **k: _Stop(requested=True))
    assert _cli(fake_dataset, tmp_path) is None
    out = capsys.readouterr().out
    assert "Preempted: fold 1 is incomplete" in out
    metrics = tmp_path / "metrics"
    # fold 1 stopped after epoch 1 of 2: no completion artifacts
    assert not (metrics / "fold_1_baseline_training_history.json").exists()
    assert not (metrics / "baseline_cv_summary.json").exists()
    monkeypatch.undo()
    assert _cli(fake_dataset, tmp_path, "--resume-from", "auto") is not None
    assert (metrics / "baseline_cv_summary.json").exists()
    hist = json.loads((metrics / "fold_1_baseline_training_history.json")
                      .read_text())
    assert len(hist["epoch"]) == 2


def test_stopped_after_a_fold_then_resumed_equals_straight(
        fake_dataset, tmp_path, monkeypatch, capsys):
    straight = _cli(fake_dataset, tmp_path / "straight")
    stop = _Stop()
    monkeypatch.setattr(classifier_loop, "GracefulShutdown",
                        lambda *a, **k: stop)
    train_one_run = classifier_loop.train_one_run

    def then_stop(*a, **k):  # the signal lands right after fold 1's epochs
        out = train_one_run(*a, **k)
        stop.requested = True
        return out
    monkeypatch.setattr(classifier_loop, "train_one_run", then_stop)
    capsys.readouterr()
    assert _cli(fake_dataset, tmp_path / "stopped") is None
    out = capsys.readouterr().out
    assert "Preempted: stopping after completed fold 1" in out
    assert not (tmp_path / "stopped" / "metrics" /
                "baseline_cv_summary.json").exists()
    monkeypatch.undo()
    resumed = _cli(fake_dataset, tmp_path / "stopped", "--resume-from",
                   "auto")
    assert capsys.readouterr().out.count("already trained") == 1
    assert resumed == straight


def test_a_single_run_keeps_its_history_when_stopped(fake_dataset,
                                                     tmp_path, monkeypatch,
                                                     capsys):
    monkeypatch.setattr(classifier_loop, "GracefulShutdown",
                        lambda *a, **k: _Stop(requested=True))
    metrics = _cli(fake_dataset, tmp_path, folds=1)
    out = capsys.readouterr().out
    assert "Note: run preempted after epoch 1/2" in out
    hist = json.loads((tmp_path / "metrics" /
                       "baseline_training_history.json").read_text())
    assert len(hist["epoch"]) == 1 and np.isfinite(metrics["loss"])


def test_trace_dir_writes_one_trace(fake_dataset, tmp_path):
    trace_dir = tmp_path / "trace"
    _cli(fake_dataset, tmp_path, "--trace-dir", str(trace_dir), folds=1)
    traces = list(trace_dir.iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
