"""``--steps-per-call K`` in xgan_torch (``xgan_torch/train/
multistep.py`` and the DCGAN loop's chunked dispatch) against the JAX
package's.

``grid_iters`` with a chunk equals ``xgan.train.loop_common.grid_iters``
over a grid of cases; the DCGAN trainer with K = 2 on an epoch of three
batches (one chunk of two, then the masked tail as one step) ends where
K = 1 does, within the tolerance of tests/test_multistep.py (rtol 2e-4,
atol 2e-5): history, sample sheets and final weights, also composed with
``--grad-accum 2`` and ``--ema-decay``. On the CPU a call is a plain loop
of K steps; the CUDA graph is held against eager steps by the card tests
(tests/test_torch_port_cuda.py). The WGAN-GP and CGAN trainers still
refuse ``--grad-accum`` and ``--steps-per-call`` other than 1."""
import itertools
import os

import numpy as np
import pytest
import torch

from xgan.train.loop_common import grid_iters as jax_grid_iters
from xgan_torch.cli import train_cgan, train_gan, train_wggan
from xgan_torch.train.loop_common import grid_iters
from xgan_torch.train.multistep import StepsPerCall

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5  # tests/test_multistep.py:17


@pytest.mark.parametrize("chunk", [1, 2, 3, 4])
def test_grid_iters_matches_jax(chunk):
    cases = itertools.product(range(0, 13), (1, 2, 5), (False, True),
                              range(0, 6), (6, 9))
    for iters, interval, last, i, num_batches in cases:
        assert grid_iters(iters, chunk, interval, last, i, num_batches) == \
            jax_grid_iters(iters, chunk, interval, last, i, num_batches), \
            (iters, chunk, interval, last, i, num_batches)


def _run(fake_dataset, out, *extra):
    history = train_gan.main([
        "--cpu", "--data-dir", fake_dataset["data_dir"],
        "--model-dir", str(out / "models"),
        "--output-dir", str(out / "results"),
        "--results-dir", str(out / "metrics"),
        "--figures-dir", str(out / "figures"),
        "--cache-dir", str(out / "cache"), "--image-size", "32",
        "--feature-maps-g", "8", "--feature-maps-d", "8",
        "--latent-dim", "16", "--epochs", "1", "--batch-size", "10",
        "--vis-batch-size", "8", "--save-interval", "1", *extra])
    gan_dir = out / "models" / "gan"
    finals = {name: torch.load(gan_dir / name, weights_only=True)
              for name in sorted(os.listdir(gan_dir)) if "final" in name}
    sheets = sorted(os.listdir(out / "results" / "gan_images"))
    return history, finals, sheets


@pytest.mark.parametrize("extra", [[], ["--grad-accum", "2"],
                                   ["--ema-decay", "0.9"]],
                         ids=["plain", "accum2", "ema"])
def test_k2_matches_k1(fake_dataset, tmp_path, extra):
    """24 images at B = 10: batches 1-2 go as one K = 2 call, the tail
    (4 valid rows) as one masked step."""
    h1, f1, s1 = _run(fake_dataset, tmp_path / "k1", *extra)
    h2, f2, s2 = _run(fake_dataset, tmp_path / "k2", "--steps-per-call",
                      "2", *extra)
    assert len(h2["G_losses_iter"]) == 3
    for key in h1:
        np.testing.assert_allclose(h2[key], h1[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert set(f1) == set(f2)
    for name in f1:
        for k, v in f1[name].items():
            torch.testing.assert_close(f2[name][k].float(), v.float(),
                                       rtol=RTOL, atol=ATOL,
                                       msg=f"{name} {k}")
    # sheets at iterations 0, 1, 2; the chunk renders only its last (1)
    assert s1 == [f"fake_samples_epoch_001_iter_{t:06d}.png"
                  for t in (0, 1, 2)]
    assert s2 == [f"fake_samples_epoch_001_iter_{t:06d}.png"
                  for t in (1, 2)]


def test_dispatcher_is_a_loop_of_k_steps_on_the_cpu():
    seen = []

    def step(idx):
        seen.append(idx.clone())
        return idx.float().sum().reshape(1)

    multi = StepsPerCall(step, 3, torch.Generator())
    chunk = torch.arange(12).reshape(3, 4)
    out = multi(chunk)
    assert out.shape == (3, 1) and out[:, 0].tolist() == [6.0, 22.0, 38.0]
    assert [s.tolist() for s in seen] == chunk.tolist()
    assert multi.graph is None and multi.replays == 0
    with pytest.raises(ValueError):
        multi(chunk[:2])


@pytest.mark.parametrize("flag", [["--grad-accum", "2"],
                                  ["--steps-per-call", "2"]])
@pytest.mark.parametrize("cli", [train_wggan, train_cgan],
                         ids=["wgan", "cgan"])
def test_wgan_and_cgan_refuse_step_level_flags(cli, flag, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--cpu", *flag])
    assert e.value.code == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("Error:") and flag[0] in last
    assert "not supported" in last
