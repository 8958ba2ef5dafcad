"""The three samplers across two gloo ranks on the CPU
(``tests/torch_port_dist_worker.py``) against one process.

- ``generate_images`` of the DCGAN, WGAN-GP and conditional CGAN
  generators (32 px, widths 8) with a mesh of two ranks: 7 images in
  global batches of 4, each rank rendering and writing its 2 rows of a
  batch under their global names. In f32 the file set is byte-equal to
  one process's at the same batch, ``synthetic_00001.png`` to
  ``synthetic_00007.png`` and nothing past ``num_images`` (the 8th row,
  rank 1's, is never written). In bf16 (the DCGAN generator) every pixel
  within 3 u8 levels of the one-process render: a smaller batch may round
  otherwise.
- The DCGAN sampler CLI under a launch of two ranks with ``--batch-size
  3``: the batch becomes 4 (a multiple of the ranks, as the JAX sampler
  pads it), and the files are byte-equal to one process at
  ``--batch-size 4``; rank 0 alone prints the totals.
- A ``.pt2`` artifact under a launch exits 1 with a structured error.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_dist_worker import (ROOT, RANK_TIMEOUT, run_cases,
                                          start_ranks, wait_ranks)
from xgan_torch.cli import generate_synthetic
from xgan_torch.models import cgan, dcgan, wgan
from xgan_torch.train.sample import generate_images

torch.set_num_threads(1)

LATENT, FM, SIZE, NUM, BATCH, SEED = 8, 8, 32, 7, 4, 5
CLASSES = {"dcgan": dcgan.Generator, "wgan": wgan.Generator,
           "cgan": cgan.Generator}
# run -> (generator kind, compute dtype)
RUNS = {"dcgan": ("dcgan", torch.float32), "wgan": ("wgan", torch.float32),
        "cgan": ("cgan", torch.float32),
        "dcgan_bf16": ("dcgan", torch.bfloat16)}
LAUNCH = {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
          "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}


def _generator(kind, seed):
    return CLASSES[kind](latent_dim=LATENT, feature_maps=FM,
                         image_size=SIZE,
                         generator=torch.Generator().manual_seed(seed))


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def sampled(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_sampler")
    runs, counts = {}, {}
    for i, (name, (kind, dtype)) in enumerate(RUNS.items()):
        g = _generator(kind, 70 + i)
        runs[name] = (kind, g.state_dict(), dtype)
        counts[name] = generate_images(
            g, output_dir=str(root / "one" / name), num_images=NUM,
            latent_dim=LATENT, batch_size=BATCH, seed=SEED, device="cpu",
            dtype=dtype, conditional=kind == "cgan")
    ranks = run_cases({"sampler": {
        "runs": runs, "out": str(root / "two"), "latent": LATENT, "fm": FM,
        "size": SIZE, "num_images": NUM, "batch_size": BATCH,
        "seed": SEED}}, root)["sampler"]
    return root, counts, ranks


@pytest.mark.parametrize("run", ["dcgan", "wgan", "cgan"])
def test_two_ranks_write_one_processes_files_in_f32(sampled, run):
    root, counts, ranks = sampled
    want = _files(root / "one" / run)
    assert list(want) == [f"synthetic_{i:05d}.png"
                          for i in range(1, NUM + 1)]
    assert counts[run] == NUM and [r[run] for r in ranks] == [NUM, NUM]
    assert _files(root / "two" / run) == want


def test_two_ranks_bf16_within_three_levels(sampled):
    root = sampled[0]
    want = _files(root / "one" / "dcgan_bf16")
    got = _files(root / "two" / "dcgan_bf16")
    assert list(got) == list(want)
    for f in want:
        a, b = (np.asarray(Image.open(d / "dcgan_bf16" / f), np.int16)
                for d in (root / "two", root / "one"))
        assert np.abs(a - b).max() <= 3, f


def _cli_argv(g_path, out, batch):
    return [sys.executable, "-u", "-m", "xgan_torch.cli.generate_synthetic",
            "--cpu", "--model-path", str(g_path), "--output-dir", str(out),
            "--num-images", "5", "--batch-size", str(batch),
            "--latent-dim", str(LATENT), "--feature-maps-g", str(FM),
            "--image-size", str(SIZE), "--seed", "3",
            "--compute-dtype", "f32"]


def test_sampler_cli_under_a_launch_writes_one_processes_files(tmp_path):
    g_path = tmp_path / "g.pth"
    torch.save(_generator("dcgan", 80).state_dict(), g_path)
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH}
    env["OMP_NUM_THREADS"] = "1"
    one = subprocess.run(_cli_argv(g_path, tmp_path / "one", 4), env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=RANK_TIMEOUT)
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-3000:]
    outs = wait_ranks(start_ranks(_cli_argv(g_path, tmp_path / "two", 3),
                                  2))
    for rc, text in outs:
        assert rc == 0, text[-4000:]
    assert "(batch 4, cpu" in outs[0][1] and "2 ranks" in outs[0][1]
    assert "Finished generating 5 images" in outs[0][1]
    assert "Finished generating" not in outs[1][1]
    want = _files(tmp_path / "one")
    assert len(want) == 5 and _files(tmp_path / "two") == want


def test_artifact_under_a_launch_exits_1(tmp_path, monkeypatch, capsys):
    for k, v in LAUNCH.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        generate_synthetic.main(["--cpu", "--model-path",
                                 str(tmp_path / "g.pt2")])
    assert e.value.code == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("Error: a .pt2 generator artifact"), last
    assert "not supported by xgan_torch yet under a torchrun launch" in last
