"""``--steps-per-call K`` in xgan_torch (``xgan_torch/train/
multistep.py`` and the DCGAN loop's chunked dispatch) against the JAX
package's.

``grid_iters`` with a chunk equals ``xgan.train.loop_common.grid_iters``
over a grid of cases; the DCGAN trainer with K = 2 on an epoch of three
batches (one chunk of two, then the masked tail as one step) ends where
K = 1 does, within the tolerance of tests/test_multistep.py (rtol 2e-4,
atol 2e-5): history, sample sheets and final weights, also composed with
``--grad-accum 2`` and ``--ema-decay``; so do the WGAN-GP and CGAN
trainers, alone and composed with ``--grad-accum 2``. A CGAN dispatcher
passes the epoch to every step as a device input, so one dispatcher
holds the gate open at epoch 4 and lets it close at epoch 5. On the CPU
a call is a plain loop of K steps; the CUDA graph is held against eager
steps by the card tests (tests/test_torch_port_cuda.py)."""
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


def _run(fake_dataset, out, *extra, cli=train_gan, sub="gan", fm="8"):
    history = cli.main([
        "--cpu", "--data-dir", fake_dataset["data_dir"],
        "--model-dir", str(out / "models"),
        "--output-dir", str(out / "results"),
        "--results-dir", str(out / "metrics"),
        "--figures-dir", str(out / "figures"),
        "--cache-dir", str(out / "cache"), "--image-size", "32",
        "--feature-maps-g", fm, "--feature-maps-d", fm,
        "--latent-dim", "16", "--epochs", "1", "--batch-size", "10",
        "--vis-batch-size", "8", "--save-interval", "1", *extra])
    gan_dir = out / "models" / sub
    finals = {name: torch.load(gan_dir / name, weights_only=True)
              for name in sorted(os.listdir(gan_dir)) if "final" in name}
    sheets = sorted(os.listdir(out / "results" / f"{sub}_images"))
    return history, finals, sheets


def _assert_k2_matches_k1(run1, run2):
    (h1, f1, s1), (h2, f2, s2) = run1, run2
    for key in h1:
        np.testing.assert_allclose(h2[key], h1[key], rtol=RTOL, atol=ATOL,
                                   err_msg=key)
    assert set(f1) == set(f2)
    for name in f1:
        for k, v in f1[name].items():
            torch.testing.assert_close(f2[name][k].float(), v.float(),
                                       rtol=RTOL, atol=ATOL,
                                       msg=f"{name} {k}")
    return s1, s2


@pytest.mark.parametrize("extra", [[], ["--grad-accum", "2"],
                                   ["--ema-decay", "0.9"]],
                         ids=["plain", "accum2", "ema"])
def test_k2_matches_k1(fake_dataset, tmp_path, extra):
    """24 images at B = 10: batches 1-2 go as one K = 2 call, the tail
    (4 valid rows) as one masked step."""
    run1 = _run(fake_dataset, tmp_path / "k1", *extra)
    run2 = _run(fake_dataset, tmp_path / "k2", "--steps-per-call", "2",
                *extra)
    assert len(run2[0]["G_losses_iter"]) == 3
    s1, s2 = _assert_k2_matches_k1(run1, run2)
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


@pytest.mark.parametrize("extra", [[], ["--grad-accum", "2"]],
                         ids=["plain", "accum2"])
@pytest.mark.parametrize("cli,sub", [(train_wggan, "wgan"),
                                     (train_cgan, "cgan")],
                         ids=["wgan", "cgan"])
def test_wgan_and_cgan_k2_match_k1(fake_dataset, tmp_path, cli, sub, extra):
    """As the DCGAN case: one K = 2 call, then the masked tail (4 valid
    rows, so at A = 2 a fully padded microbatch) as one step."""
    kw = {"cli": cli, "sub": sub}
    if sub == "wgan":
        extra = [*extra, "--critic-iters", "2"]
    run1 = _run(fake_dataset, tmp_path / "k1", *extra, **kw)
    run2 = _run(fake_dataset, tmp_path / "k2", "--steps-per-call", "2",
                *extra, **kw)
    assert len(run2[0]["G_losses" if sub == "wgan" else
                       "G_losses_iter"]) == 3
    s1, s2 = _assert_k2_matches_k1(run1, run2)
    assert s2 == [f"fake_samples_epoch_001_iter_{t:06d}.png"
                  for t in (1, 2)]


def test_cgan_dispatcher_reads_the_epoch_of_each_call():
    """One dispatcher of K = 2 CGAN steps through the gate-closing probe
    of tests/test_torch_port_cgan_step.py: at epoch 4 D moves, at epoch
    5 (the same dispatcher, the epoch a device input) its gate closes and
    D and its Adam state stay bitwise as they were."""
    from tests.test_torch_port_cgan_step import _probe_port
    from xgan_torch.train.cgan import cgan_step
    g, d, vgg, opt_g, opt_d = _probe_port(seed=21)
    images = torch.full((16, 32, 32, 3), 255, dtype=torch.uint8)
    labels = torch.arange(16) % 2
    gen = torch.Generator().manual_seed(22)

    def step(idx, epoch):
        return cgan_step(g, d, vgg, opt_g, opt_d, images, labels, idx,
                         epoch, latent_dim=8, generator=gen)
    multi = StepsPerCall(step, 2, gen)
    chunk = torch.arange(16).reshape(2, 8)
    before = [p.clone() for p in d.parameters()]
    m = multi(chunk, torch.tensor(4))
    assert m.shape == (2, 7) and (m[:, 2] > 0.9).all()
    assert not all(torch.equal(a, b) for a, b in zip(d.parameters(),
                                                     before))
    before = [p.clone() for p in d.parameters()]
    steps = opt_d.state_dict()["state"][0]["step"].clone()
    multi(chunk, torch.tensor(5))
    assert all(torch.equal(a, b) for a, b in zip(d.parameters(), before))
    assert torch.equal(opt_d.state_dict()["state"][0]["step"], steps)


@pytest.mark.parametrize("flag", [["--grad-accum", "2"],
                                  ["--steps-per-call", "2"]])
@pytest.mark.parametrize("cli", [train_wggan, train_cgan],
                         ids=["wgan", "cgan"])
def test_wgan_and_cgan_take_step_level_flags(cli, flag, tmp_path, capsys):
    """The flags pass the refusal: the run goes on to the dataset check."""
    assert cli.main(["--cpu", *flag, "--data-dir", str(tmp_path / "none"),
                     "--model-dir", str(tmp_path / "m"),
                     "--output-dir", str(tmp_path / "o"),
                     "--results-dir", str(tmp_path / "r"),
                     "--figures-dir", str(tmp_path / "f")]) is None
    out = capsys.readouterr().out
    assert "Dataset not found" in out and "not supported" not in out
