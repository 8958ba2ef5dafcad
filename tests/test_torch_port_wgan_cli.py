"""``python -m xgan_torch.cli.train_wggan --cpu`` and
``python -m xgan_torch.cli.generate_synthetic_wgan --cpu`` against the JAX
package's WGAN-GP CLIs.

- The trainer on the fixture dataset (24 images at 32 px, batch 16, so
  the second batch of each epoch is a masked tail; 2 epochs; 2 critic
  updates a step; tiny widths; every output directory, ``--figures-dir``
  included, under the test's temporary directory): the history has the
  JAX schema with ``critic_iters`` critic losses a step, the sample sheets
  decode to the expected grid, the checkpoints load strictly (the final
  generator also into the JAX package and through the port's WGAN
  sampler), ``wgan_loss_curve.png`` decodes, Adam runs with betas
  (β1, 0.9), and the flags the port does not support exit 1.
- The sampler from a ``generator_final.pth`` that the JAX package's own
  trainer helper writes: for the same weights and the noise the JAX
  sampler draws (injected), the PNGs are within 1 u8 level of the ones
  the JAX sampler writes (f32 on both sides).
- The flags and defaults of both CLIs are the JAX CLIs'; the loss figure
  has the JAX writer's file name; the progress line shows the last
  critic loss as the JAX one does.
"""
import importlib.util
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_generator
from xgan.models import wgan as jax_wgan
from xgan.models.pretrained import load_torch_gan_generator
from xgan_torch import kernels
from xgan_torch.cli import generate_synthetic_wgan as sample_cli
from xgan_torch.cli import train_wggan as cli
from xgan_torch.models.wgan import Critic, Generator
from xgan_torch.native.png import decode_png
from xgan_torch.train import wgan_loop

torch.set_num_threads(1)

SIZE, B, EPOCHS, FM, LATENT, VIS, N_CRITIC = 32, 16, 2, 8, 16, 10, 2
HISTORY_KEYS = {"D_losses", "G_losses", "D_losses_epoch", "G_losses_epoch"}
MODEL_FLAGS = ["--image-size", str(SIZE), "--feature-maps-g", str(FM),
               "--latent-dim", str(LATENT)]


def _jax_parser(script):
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", script)
    spec = importlib.util.spec_from_file_location(f"jax_{script[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


def _read_pngs(out_dir):
    names = sorted(os.listdir(out_dir))
    return names, np.stack([decode_png(os.path.join(out_dir, n))
                            for n in names])


@pytest.fixture(scope="module")
def run(tmp_path_factory, fake_dataset):
    out = tmp_path_factory.mktemp("wgan")
    argv = ["--cpu", "--data-dir", fake_dataset["data_dir"],
            "--model-dir", str(out / "models"),
            "--output-dir", str(out / "results"),
            "--results-dir", str(out / "metrics"),
            "--figures-dir", str(out / "figures"),
            "--cache-dir", str(out / "cache"), *MODEL_FLAGS,
            "--feature-maps-d", str(FM), "--epochs", str(EPOCHS),
            "--batch-size", str(B), "--vis-batch-size", str(VIS),
            "--critic-iters", str(N_CRITIC), "--save-interval", "3",
            "--checkpoint-interval", "1"]
    betas = []
    adam = wgan_loop.adam
    mp = pytest.MonkeyPatch()
    mp.setattr(wgan_loop, "adam", lambda params, lr, beta1, beta2=0.999,
               **kw: (betas.append((lr, beta1, beta2)),
                      adam(params, lr, beta1, beta2, **kw))[1])
    kernels.reset_launch_counts()
    try:
        history = cli.main(argv)
    finally:
        mp.undo()
    assert sum(kernels.LAUNCHES.values()) == 0  # the CPU runs no kernel
    return SimpleNamespace(history=history, out=out, betas=betas,
                           n=fake_dataset["n_train"])


def test_history_has_the_reference_schema(run):
    saved = json.loads((run.out / "metrics" / "wgan_training_history.json")
                       .read_text())
    assert set(saved) == HISTORY_KEYS and saved == run.history
    steps = EPOCHS * math.ceil(run.n / B)
    assert len(saved["D_losses"]) == steps * N_CRITIC
    assert len(saved["G_losses"]) == steps
    assert len(saved["D_losses_epoch"]) == len(saved["G_losses_epoch"]) \
        == EPOCHS
    for key in HISTORY_KEYS:
        assert np.isfinite(saved[key]).all(), key
    per_epoch = np.reshape(saved["D_losses"], (EPOCHS, -1)).mean(axis=1)
    np.testing.assert_allclose(saved["D_losses_epoch"], per_epoch, rtol=1e-6)
    # the JAX trainer's Adam: betas (beta1, 0.9) for G and the critic
    assert run.betas == [(2e-4, 0.5, 0.9)] * 2


def test_sample_sheets_decode(run):
    sheets = sorted(os.listdir(run.out / "results" / "wgan_images"))
    # iterations 0 and 3 (--save-interval 3), and the last (3) again
    assert sheets == ["fake_samples_epoch_001_iter_000000.png",
                      "fake_samples_epoch_002_iter_000003.png"]
    rows = math.ceil(VIS / 8)
    for name in sheets:
        img = decode_png(str(run.out / "results" / "wgan_images" / name))
        assert img.shape == (rows * (SIZE + 2) + 2, 8 * (SIZE + 2) + 2, 3)
        assert (img[:2] == 255).all() and img.std() > 0


def test_checkpoints_load_strictly(run, tmp_path):
    wgan_dir = run.out / "models" / "wgan"
    names = sorted(os.listdir(wgan_dir))
    assert names == sorted(
        [f"{m}_epoch_{e:03d}.pth" for m in ("generator", "discriminator")
         for e in (1, 2)] + ["generator_final.pth",
                             "discriminator_final.pth", "snapshot_last.pth"])
    snap = torch.load(wgan_dir / "snapshot_last.pth", weights_only=True)
    assert set(snap) == {"g", "c", "opt_g", "opt_c", "rng", "epoch",
                         "iters"}
    assert snap["epoch"] == 2
    for name in names[:-1]:
        sd = torch.load(wgan_dir / name, weights_only=True)
        model = (Generator(LATENT, 3, FM, SIZE) if name.startswith("gen")
                 else Critic(3, FM, SIZE))
        model.load_state_dict(sd, strict=True)
    params, _ = load_torch_gan_generator(str(wgan_dir /
                                             "generator_final.pth"))
    assert params["ConvTranspose_0"]["kernel"].shape == (1, 1, LATENT,
                                                         FM * 16)
    stats = sample_cli.main([
        "--cpu", "--model-path", str(wgan_dir / "generator_final.pth"),
        "--output-dir", str(tmp_path / "synth"), "--num-images", "3",
        "--batch-size", "2", *MODEL_FLAGS])
    assert stats["written"] == 3
    img = decode_png(str(tmp_path / "synth" / "synthetic_00003.png"))
    assert img.shape == (SIZE, SIZE, 3)


def test_loss_curve_figure(run):
    assert os.listdir(run.out / "figures") == ["wgan_loss_curve.png"]
    img = decode_png(str(run.out / "figures" / "wgan_loss_curve.png"))
    assert img.shape == (600, 1200, 3) and img.std() > 0


@pytest.mark.parametrize("script,parser", [
    ("train_wggan.py", cli.build_parser),
    ("generate_synthetic_wgan.py", sample_cli.build_parser)])
def test_flags_and_defaults_follow_the_jax_cli(script, parser):
    ours = {a.dest: a.default for a in parser()._actions}
    theirs = {a.dest: a.default for a in _jax_parser(script)._actions}
    assert set(theirs) <= set(ours)
    for dest, default in theirs.items():
        if dest not in ("cpu", "help"):
            assert ours[dest] == default, dest
    if script == "train_wggan.py":
        assert (ours["epochs"], ours["batch_size"], ours["critic_iters"],
                ours["lambda_gp"]) == (30, 64, 5, 10.0)


@pytest.mark.parametrize("flag", [["--model-parallel", "4"],
                                  ["--shard-opt-state"],
                                  ["--model-parallel", "2"]])
def test_unported_flags_exit_1(flag, tmp_path, capsys):
    """The flags a port once refused run as the JAX CLI does on one
    device: ``--model-parallel N`` prints its note and trains replicated,
    ``--shard-opt-state`` has no ranks to shard over; the run goes on to
    the dataset check."""
    assert cli.main(["--cpu", *flag, "--data-dir", str(tmp_path / "none"),
                     "--model-dir", str(tmp_path / "m"),
                     "--output-dir", str(tmp_path / "o"),
                     "--results-dir", str(tmp_path / "r"),
                     "--figures-dir", str(tmp_path / "f")]) is None
    out = capsys.readouterr().out
    assert "Dataset not found" in out and "not supported" not in out
    note = (f"Note: --model-parallel {flag[-1]} does not divide the 1 "
            "available device(s); training with replicated params.")
    assert (note in out) == (flag[0] == "--model-parallel")

@pytest.mark.parametrize("flag", [["--resume-from", "auto"],
                                  ["--ema-decay", "0.999"],
                                  ["--trace-dir", "t"],
                                  ["--grad-accum", "2"],
                                  ["--steps-per-call", "2"],
                                  ["--shard-store"]])
def test_ported_loop_flags_are_accepted(flag, tmp_path, capsys):
    """The loop flags the port now supports parse and pass the refusal:
    the run goes on to the dataset check."""
    assert cli.main(["--cpu", *flag, "--data-dir", str(tmp_path / "none"),
                     "--model-dir", str(tmp_path / "m"),
                     "--output-dir", str(tmp_path / "o"),
                     "--results-dir", str(tmp_path / "r"),
                     "--figures-dir", str(tmp_path / "f")]) is None
    out = capsys.readouterr().out
    assert "Dataset not found" in out and "not supported" not in out



def test_no_cuda_without_cpu_flag_exits_1(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU error")
    for main, argv in ((cli.main, ["--data-dir", str(tmp_path)]),
                       (sample_cli.main, ["--model-path",
                                          str(tmp_path / "g.pth")])):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 1
        last = capsys.readouterr().out.strip().splitlines()[-1]
        assert last.startswith("Error:"), last


def test_default_directories_land_in_the_working_directory(
        tmp_path, monkeypatch, capsys):
    """Without the path flags the trainer makes the reference's
    ./models/wgan and ./results/{wgan_images,metrics,figures} where it
    runs."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--cpu", "--data-dir", "none"]) is None
    assert "Dataset not found" in capsys.readouterr().out
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*")) == [
        "models", "models/wgan", "results", "results/figures",
        "results/metrics", "results/wgan_images"]


def test_sampler_matches_the_jax_sampler(tmp_path):
    """A ``generator_final.pth`` written by the JAX package's trainer
    helper (``export_generator_pth``), sampled by both packages: the JAX
    sampler with its own draws, the port with those draws injected."""
    import jax
    from xgan.train.common import ModelState
    from xgan.train.loop_common import export_generator_pth
    from xgan.train.sample import generate_images as jax_generate
    from xgan_torch.train.sample import generate_images, load_generator
    model, params, stats = jax_generator(LATENT, FM, SIZE, seed=3,
                                         family=jax_wgan)
    export_generator_pth(str(tmp_path), "wgan",
                         ModelState(params=params, batch_stats=stats,
                                    opt_state=None))
    pth = str(tmp_path / "generator_final.pth")
    n, batch, seed = 12, 8, 5  # 8: the test mesh's 8 CPU devices
    jax_generate(model, {"params": params, "batch_stats": stats},
                 output_dir=str(tmp_path / "jax"), num_images=n,
                 latent_dim=LATENT, batch_size=batch, seed=seed)
    noise = [np.array(jax.random.normal(
        jax.random.fold_in(jax.random.key(seed), k), (batch, LATENT)))
        for k in range(2)]
    g = load_generator(Generator(LATENT, 3, FM, SIZE), pth)
    assert generate_images(g, output_dir=str(tmp_path / "port"),
                           num_images=n, latent_dim=LATENT, batch_size=batch,
                           device="cpu", dtype=torch.float32,
                           noise=noise) == n
    names, got = _read_pngs(tmp_path / "port")
    assert names == sorted(os.listdir(tmp_path / "jax"))
    want = _read_pngs(tmp_path / "jax")[1]
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert want.std() > 20  # the images span the u8 range


@pytest.mark.parametrize("ext", [".msgpack", ".stablehlo"])
def test_sampler_cli_refuses_other_formats(tmp_path, capsys, ext):
    """.stablehlo needs JAX and exits 1; a .msgpack of the JAX package
    samples the images of its .pth twin."""
    if ext == ".stablehlo":
        with pytest.raises(SystemExit) as e:
            sample_cli.main(["--cpu", "--model-path",
                             str(tmp_path / f"g{ext}"), *MODEL_FLAGS])
        assert e.value.code == 1
        assert "not supported by xgan_torch" in capsys.readouterr().out
        return
    from xgan.io_.checkpoint import save_variables
    model, params, stats = jax_generator(LATENT, FM, SIZE, seed=4,
                                         family=jax_wgan)
    from xgan.models.pretrained import save_torch_gan_generator
    pth = str(tmp_path / "generator_final.pth")
    save_torch_gan_generator(pth, params, stats)
    msgpack = str(tmp_path / "generator_final.msgpack")
    save_variables(msgpack, {"params": params, "batch_stats": stats})
    for path, out in ((msgpack, "out"), (pth, "twin")):
        sample_cli.main(["--cpu", "--model-path", path, "--output-dir",
                         str(tmp_path / out), "--num-images", "5",
                         "--batch-size", "2", *MODEL_FLAGS])
    names, imgs = _read_pngs(tmp_path / "out")
    assert len(names) == 5 and imgs.std() > 20
    assert np.array_equal(imgs, _read_pngs(tmp_path / "twin")[1])


def test_loss_figure_matches_jax(tmp_path, monkeypatch):
    """The JAX writer's file name, with every critic and G loss drawn in
    the two default colours."""
    import matplotlib.pyplot as plt
    from xgan.io_ import figures as jax_figures
    from xgan_torch.io_ import figures, plots
    monkeypatch.setattr(plt, "savefig", lambda path, **_: open(
        path, "wb").close())
    rng = np.random.default_rng(0)
    history = {"D_losses": list(rng.normal(size=50) - 5),
               "G_losses": list(rng.normal(size=10))}
    for name, mod in (("port", figures), ("jax", jax_figures)):
        (tmp_path / name).mkdir()
        mod.plot_wgan_losses(history, str(tmp_path / name
                                          / "wgan_loss_curve.png"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == ["wgan_loss_curve.png"]
    img = decode_png(str(tmp_path / "port" / "wgan_loss_curve.png"))
    assert img.shape == (600, 1200, 3)
    for color in plots.CYCLE[:2]:
        assert (np.abs(img.astype(int) - plots.rgb(color)).max(-1)
                <= 1).any()


def test_progress_line_shows_the_last_critic_loss():
    from xgan.train.loop_common import wgan_live_postfix as jax_postfix
    from xgan_torch.train.loop_common import wgan_live_postfix
    row = np.array([1.5, -2.25, 0.75], np.float32)  # [d_1, d_2, g]
    assert wgan_live_postfix(row) == jax_postfix(row[:-1]) \
        == "Loss_D: -2.2500"
