"""The result line: exactly the result format's keys, the numbers compared
last, and a run that finds no card printing none."""
import json
import os
import subprocess
import sys

import pytest
import torch

from bench_port import catalog, harness

ROOT = catalog.ROOT
TOP = {"correct", "attempted", "failed", "metrics", "device", "check"}


def _last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("name", ["wgan224-b64-n5", "dcgan224-b128-k4"])
def test_untraced_line_has_the_result_keys(name, capsys):
    torch.set_num_threads(2)
    rc = harness.main(["--workload", name, "--seed", "4294967311",
                       "--seconds", "0.05"], 0.0, device="cpu", tiny=True)
    captured = capsys.readouterr()
    assert rc == 0
    line = _last_line(captured.out)
    assert set(line) == TOP and list(line)[-1] == "check"
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {
        m["name"] for m in catalog.metrics_of(catalog.benchmark(), name,
                                              trace=False)}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert line["metrics"]["train_imgs_per_s"]["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} \
        <= set(line["device"])
    assert set(line["check"]) == set(catalog.cell(name)["limits"])
    for v in line["check"].values():
        assert v["value"] <= v["limit"]
    # the numbers compared are standard error's last lines
    tail = captured.err.strip().splitlines()[-len(line["check"]):]
    assert [t.split()[1] for t in tail] == list(line["check"])


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "dcgan224-b128-k4",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "dcgan224-b128-k4",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", "dcgan224-b128-k4",
         "--seed", "2147483659", "--seconds", "2", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = _last_line(proc.stdout)
    assert line["correct"] is True, line["check"]
    assert line["device"]["busy_s"] > 0
    assert line["device"]["platform"] == "gpu"
    assert set(line["metrics"]) <= {m["name"] for m in
                                    catalog.benchmark()["per_layer"]}
