"""xgan_torch's data-layer self-test CLI against src/data_loader.py on
the fixture: each ``--test-mode`` prints the same lines (the dataset
check, the batch shapes and dtypes, the k-fold split sizes, the labels
and their distribution), except the labels of the mixer's batch at ratio
0.5, which its draws decide (``torch.Generator(0)`` in the port,
``jax.random.key(0)`` in the JAX package); ratios 0 and 1 do not depend
on the draws and must match."""
import contextlib
import importlib.util
import io
import os
import re
import sys

import pytest
import torch

from xgan_torch.cli import data_loader

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
MODES = ("basic", "kfold", "augmented", "kfold_augmented", "phased_kfold")


def _jax_lines(argv):
    spec = importlib.util.spec_from_file_location(
        "jax_data_loader", os.path.join(SRC, "data_loader.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old, buf = sys.argv, io.StringIO()
    sys.argv = ["data_loader.py", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            mod.main()
    finally:
        sys.argv = old
    return buf.getvalue().splitlines()


def _port_lines(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        data_loader.main(argv)
    return buf.getvalue().splitlines()


def _flags(fake_dataset, cache, mode):
    return ["--cpu", "--data-dir", fake_dataset["data_dir"],
            "--synthetic-dir", fake_dataset["synthetic_dir"],
            "--cache-dir", str(cache), "--image-size", "32",
            "--test-mode", mode]


@pytest.mark.parametrize("mode", MODES)
def test_lines_match_jax(fake_dataset, tmp_path, mode):
    want = _jax_lines(_flags(fake_dataset, tmp_path / "jax", mode))
    got = _port_lines(_flags(fake_dataset, tmp_path / "port", mode))
    assert len(got) == len(want)
    assert any("images (4, 32, 32, 3) float32" in ln for ln in got)
    for a, b in zip(got, want):
        if "ratio=0.5" in b:
            # the draws decide these labels; the shape and dtype do not
            assert a.split(", labels")[0] == b.split(", labels")[0]
            counts = re.search(r"distribution \[(\d+), (\d+)\]", a)
            assert sum(map(int, counts.groups())) == 4
        else:
            assert a == b


def test_missing_dataset_finishes_with_the_notice(tmp_path, capsys):
    data_loader.main(["--cpu", "--data-dir", str(tmp_path / "none")])
    out = capsys.readouterr().out
    assert "Dataset not found" in out
    assert "Please download the dataset first" in out


def test_error_in_a_mode_is_reported_and_the_run_finishes(fake_dataset,
                                                          tmp_path, capsys):
    """The reference's self-test contract: a failing source prints its
    error and traceback, and the run still finishes."""
    data_loader.main(["--cpu", "--data-dir", fake_dataset["data_dir"],
                      "--synthetic-dir", str(tmp_path / "missing"),
                      "--cache-dir", str(tmp_path / "c"), "--image-size",
                      "32", "--test-mode", "augmented"])
    captured = capsys.readouterr()
    assert "Error using augmented:" in captured.out
    assert "Traceback" in captured.err
    assert captured.out.rstrip().endswith("Data pipeline self-test finished.")


def test_without_a_card_refuses(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks CUDA-less hosts")
    with pytest.raises(SystemExit) as e:
        data_loader.main(["--data-dir", str(tmp_path)])
    assert e.value.code == 1
    assert capsys.readouterr().out.startswith("Error: ")


def test_defaults_match_the_jax_cli():
    args = data_loader.build_parser().parse_args([])
    assert (args.data_dir, args.synthetic_dir, args.batch_size, args.k_folds,
            args.image_size, args.cache_dir, args.test_mode, args.cpu) == (
        "./data/processed", "./data/synthetic", 4, 3, 224, "./data/cache",
        "basic", False)
