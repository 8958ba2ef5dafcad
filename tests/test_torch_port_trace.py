"""``--trace-dir`` in xgan_torch's three GAN trainers, on the CPU: the
``torch.profiler`` window of ``maybe_trace`` writes exactly one
Chrome/TensorBoard trace, of epoch ``trace_epoch(start, epochs)`` (the
JAX package's choice), into the directory; without the flag no trace is
written anywhere. ``trace_epoch`` equals the JAX package's."""
import json

import pytest
import torch

from xgan.train.loop_common import trace_epoch as jax_trace_epoch
from xgan_torch.cli import train_cgan, train_gan, train_wggan
from xgan_torch.train.loop_common import trace_epoch
from xgan_torch.utils.timer import maybe_trace

torch.set_num_threads(1)

CLIS = {"dcgan": (train_gan, []), "wgan": (train_wggan,
                                           ["--critic-iters", "1"]),
        "cgan": (train_cgan, [])}


def test_trace_epoch_matches_jax():
    for start in range(4):
        for epochs in range(start + 1, start + 4):
            assert trace_epoch(start, epochs) == jax_trace_epoch(start,
                                                                 epochs)


@pytest.mark.parametrize("name", sorted(CLIS))
def test_trace_dir_writes_one_trace(fake_dataset, tmp_path, name):
    cli, extra = CLIS[name]

    def run(sub, *flags):
        out = tmp_path / sub
        cli.main(["--cpu", "--data-dir", fake_dataset["data_dir"],
                  "--model-dir", str(out / "models"),
                  "--output-dir", str(out / "results"),
                  "--results-dir", str(out / "metrics"),
                  "--figures-dir", str(out / "figures"),
                  "--cache-dir", str(tmp_path / "cache"),
                  "--image-size", "32", "--feature-maps-g", "8",
                  "--feature-maps-d", "8", "--latent-dim", "16",
                  "--epochs", "2", "--batch-size", "16",
                  "--limit-batches", "1", "--vis-batch-size", "8", *extra,
                  *flags])
        return out

    out = run("traced", "--trace-dir", str(tmp_path / "traced" / "trace"))
    traces = sorted((out / "trace").iterdir())
    assert len(traces) == 1 and traces[0].name.endswith(".pt.trace.json")
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    plain = run("plain")
    assert not list(tmp_path.glob("plain/**/*.pt.trace.json"))
    assert sorted(p.relative_to(plain).as_posix() for p in plain.iterdir()) \
        == ["figures", "metrics", "models", "results"]


def _trace_names(trace_dir) -> list:
    traces = list(trace_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1, traces
    return [e.get("name") for e in
            json.loads(traces[0].read_text())["traceEvents"]]


def test_maybe_trace_holds_the_head_of_its_window(tmp_path):
    """The first and the last op of the window are in its one trace."""
    with maybe_trace(str(tmp_path)):
        with torch.profiler.record_function("head_of_window"):
            torch.ones(4).add_(1)
        with torch.profiler.record_function("tail_of_window"):
            torch.ones(4).mul_(2)
    names = _trace_names(tmp_path)
    assert names.count("head_of_window") == 1
    assert names.count("tail_of_window") == 1


def test_maybe_trace_writes_its_trace_on_an_exception(tmp_path):
    with pytest.raises(RuntimeError, match="stopped"):
        with maybe_trace(str(tmp_path)):
            with torch.profiler.record_function("before_the_error"):
                torch.ones(4).add_(1)
            raise RuntimeError("stopped")
    assert "before_the_error" in _trace_names(tmp_path)
