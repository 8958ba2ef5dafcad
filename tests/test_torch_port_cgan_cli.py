"""``python -m xgan_torch.cli.train_cgan --cpu`` and
``python -m xgan_torch.cli.generate_synthetic_cgan --cpu`` against the JAX
package's CGAN CLIs.

- The trainer on the fixture dataset (24 images at 32 px, batch 16, so
  the second batch of each epoch is a masked tail; 2 epochs; tiny widths;
  random VGG features; every output directory, ``--figures-dir``
  included, under the test's temporary directory): the history has the
  JAX package's nine keys, the sample sheets decode to the expected grid,
  the checkpoints load strictly (the final generator also into the JAX
  package, with the same eval images), ``cgan_loss_curve.png`` decodes.
- ``--vgg-path``: a missing file or a vgg19-shaped one prints an
  ``Error:`` line and returns None before the dataset is decoded; a
  torchvision-layout vgg16 file is loaded into the perceptual loss.
- The flags and defaults of both CLIs are the JAX CLIs'; the flags the
  port does not support exit 1, as does a missing CUDA device without
  ``--cpu``.
- The sampler from a ``.pth`` that the JAX package's codec writes: for the
  same weights, z and labels (the JAX sampler's own draws, injected), the
  PNGs are within 1 u8 level of the JAX sampler's (f32 on both sides);
  without injected draws the labels are uniform over the model's classes.
- ``plot_cgan_losses``: the JAX writer's file name, two panels, and a
  missing series prints the warning and writes nothing.
"""
import contextlib
import importlib.util
import io
import json
import math
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.torch_port_util import jax_cgan
from xgan.models.pretrained import (load_torch_cgan_generator,
                                    save_torch_cgan_generator)
from xgan_torch import kernels
from xgan_torch.cli import generate_synthetic_cgan as sample_cli
from xgan_torch.cli import train_cgan as cli
from xgan_torch.models.cgan import Discriminator, Generator
from xgan_torch.models.vgg import VGG16Features
from xgan_torch.native.png import decode_png
from xgan_torch.train import cgan_loop

torch.set_num_threads(1)

SIZE, B, EPOCHS, FM, LATENT, VIS = 32, 16, 2, 8, 16, 10
# xgan/train/cgan_loop.py:179-182
HISTORY_KEYS = {"G_losses_iter", "D_losses_iter", "D_x_iter",
                "D_G_z1_iter", "D_G_z2_iter", "G_losses_epoch",
                "D_losses_epoch", "perceptual_losses",
                "feature_matching_losses"}
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


def _train_argv(out, data_dir, *extra):
    return ["--cpu", "--data-dir", data_dir,
            "--model-dir", str(out / "models"),
            "--output-dir", str(out / "results"),
            "--results-dir", str(out / "metrics"),
            "--figures-dir", str(out / "figures"),
            "--cache-dir", str(out / "cache"), *MODEL_FLAGS,
            "--feature-maps-d", str(FM), "--vis-batch-size", str(VIS),
            *extra]


@pytest.fixture(scope="module")
def run(tmp_path_factory, fake_dataset):
    out = tmp_path_factory.mktemp("cgan")
    argv = _train_argv(out, fake_dataset["data_dir"], "--epochs",
                       str(EPOCHS), "--batch-size", str(B),
                       "--save-interval", "3", "--checkpoint-interval", "1")
    kernels.reset_launch_counts()
    stdout = io.StringIO()
    with contextlib.redirect_stdout(stdout):
        history = cli.main(argv)
    assert sum(kernels.LAUNCHES.values()) == 0  # the CPU runs no kernel
    return SimpleNamespace(history=history, out=out, stdout=stdout.getvalue(),
                           n=fake_dataset["n_train"])


def test_history_has_the_jax_schema(run):
    saved = json.loads((run.out / "metrics" / "cgan_training_history.json")
                       .read_text())
    assert set(saved) == HISTORY_KEYS and saved == run.history
    assert set(cgan_loop.HISTORY_KEYS) == HISTORY_KEYS
    steps = EPOCHS * math.ceil(run.n / B)
    for key in HISTORY_KEYS:
        want = steps if key.endswith("_iter") else EPOCHS
        assert len(saved[key]) == want, key
        assert np.isfinite(saved[key]).all(), key
    per_epoch = np.reshape(saved["G_losses_iter"], (EPOCHS, -1)).mean(axis=1)
    np.testing.assert_allclose(saved["G_losses_epoch"], per_epoch, rtol=1e-6)
    assert min(saved["perceptual_losses"]) > 0
    assert min(saved["feature_matching_losses"]) > 0
    assert "WARNING: no --vgg-path given" in run.stdout


def test_sample_sheets_decode(run):
    sheets = sorted(os.listdir(run.out / "results" / "cgan_images"))
    # iterations 0 and 3 (--save-interval 3), and the last (3) again
    assert sheets == ["fake_samples_epoch_001_iter_000000.png",
                      "fake_samples_epoch_002_iter_000003.png"]
    rows = math.ceil(VIS / 8)
    for name in sheets:
        img = decode_png(str(run.out / "results" / "cgan_images" / name))
        assert img.shape == (rows * (SIZE + 2) + 2, 8 * (SIZE + 2) + 2, 3)
        assert (img[:2] == 255).all() and img.std() > 0


def test_checkpoints_load_strictly(run, tmp_path):
    import jax.numpy as jnp
    from xgan.models import cgan as jax_cgan_models
    cgan_dir = run.out / "models" / "cgan"
    names = sorted(os.listdir(cgan_dir))
    assert names == sorted(
        [f"{m}_epoch_{e:03d}.pth" for m in ("generator", "discriminator")
         for e in (1, 2)] + ["generator_final.pth",
                             "discriminator_final.pth", "snapshot_last.pth"])
    snap = torch.load(cgan_dir / "snapshot_last.pth", weights_only=True)
    assert set(snap) == {"g", "d", "opt_g", "opt_d", "rng", "epoch",
                         "iters"}
    assert snap["epoch"] == 2
    for name in names[:-1]:
        sd = torch.load(cgan_dir / name, weights_only=True)
        model = (Generator(LATENT, 2, 3, FM, SIZE)
                 if name.startswith("gen") else Discriminator(2, 3, FM, SIZE))
        model.load_state_dict(sd, strict=True)
    # the final generator in the JAX package: the same eval images
    params, stats = load_torch_cgan_generator(str(cgan_dir /
                                                  "generator_final.pth"))
    g = Generator(LATENT, 2, 3, FM, SIZE)
    g.load_state_dict(torch.load(cgan_dir / "generator_final.pth",
                                 weights_only=True))
    z = np.random.default_rng(0).normal(size=(4, LATENT)).astype(np.float32)
    y = np.array([0, 1, 1, 0], np.int32)
    want = jax_cgan_models.Generator(
        latent_dim=LATENT, feature_maps=FM, image_size=SIZE).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(z),
        jnp.asarray(y), train=False)
    np.testing.assert_allclose(
        g(torch.from_numpy(z), torch.from_numpy(y)).numpy(),
        np.asarray(want), rtol=0, atol=1e-5)
    stats_out = sample_cli.main([
        "--cpu", "--model-path", str(cgan_dir / "generator_final.pth"),
        "--output-dir", str(tmp_path / "synth"), "--num-images", "3",
        "--batch-size", "2", *MODEL_FLAGS])
    assert stats_out["written"] == 3
    img = decode_png(str(tmp_path / "synth" / "synthetic_00003.png"))
    assert img.shape == (SIZE, SIZE, 3)


def test_loss_curve_figure(run):
    assert os.listdir(run.out / "figures") == ["cgan_loss_curve.png"]
    img = decode_png(str(run.out / "figures" / "cgan_loss_curve.png"))
    assert img.shape == (600, 1200, 3) and img.std() > 0


def _vgg_sd(deeper=False):
    """torchvision-layout vgg16 (``deeper``: vgg19) features state dict."""
    convs = ([0, 2, 5, 7, 10, 12, 14, 16] if deeper
             else [0, 2, 5, 7, 10, 12, 14, 17])
    sd, cin = {}, 3
    for idx, cout in zip(convs, [64, 64, 128, 128, 256, 256, 256, 512]):
        sd[f"features.{idx}.weight"] = torch.randn(cout, cin, 3, 3) * 0.05
        sd[f"features.{idx}.bias"] = torch.randn(cout) * 0.05
        cin = cout
    return sd


@pytest.mark.parametrize("kind", ["missing", "vgg19"])
def test_bad_vgg_path_errors_before_the_decode(kind, tmp_path, fake_dataset,
                                               monkeypatch, capsys):
    decoded = []
    monkeypatch.setattr(cgan_loop, "load_train_store",
                        lambda args: decoded.append(args))
    path = tmp_path / "vgg.pth"
    if kind == "vgg19":
        torch.save(_vgg_sd(deeper=True), path)
    history = cli.main(_train_argv(tmp_path, fake_dataset["data_dir"],
                                   "--vgg-path", str(path)))
    assert history is None and not decoded
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == (f"Error: VGG16 checkpoint {path} not found."
                    if kind == "missing" else
                    f"Error: --vgg-path {path} is not a vgg16 checkpoint: "
                    "state dict has an extra conv at features.16: a deeper "
                    "VGG (vgg19?) — its first blocks would load as a silent "
                    "frankenmodel, refusing instead")
    assert not (tmp_path / "models").exists()


def test_vgg_path_loads_into_the_perceptual_loss(tmp_path, fake_dataset,
                                                 monkeypatch, capsys):
    sd = _vgg_sd()
    path = tmp_path / "vgg16.pth"
    torch.save(sd, path)
    seen = []
    step = cgan_loop.cgan_step

    def spy(g, d, vgg, *a, **k):
        seen.append(vgg)
        return step(g, d, vgg, *a, **k)
    monkeypatch.setattr(cgan_loop, "cgan_step", spy)
    history = cli.main(_train_argv(tmp_path, fake_dataset["data_dir"],
                                   "--vgg-path", str(path), "--epochs", "1",
                                   "--batch-size", "8", "--limit-batches",
                                   "1"))
    assert len(history["G_losses_iter"]) == 1
    assert f"Loaded VGG16 ImageNet weights from {path}" in \
        capsys.readouterr().out
    assert isinstance(seen[0], VGG16Features)
    torch.testing.assert_close(seen[0].features[14].bias,
                               sd["features.14.bias"], rtol=0, atol=0)


@pytest.mark.parametrize("script,parser", [
    ("train_cgan.py", cli.build_parser),
    ("generate_synthetic_cgan.py", sample_cli.build_parser)])
def test_flags_and_defaults_follow_the_jax_cli(script, parser):
    ours = {a.dest: a.default for a in parser()._actions}
    theirs = {a.dest: a.default for a in _jax_parser(script)._actions}
    assert set(theirs) <= set(ours)
    for dest, default in theirs.items():
        if dest not in ("cpu", "help"):
            assert ours[dest] == default, dest
    if script == "train_cgan.py":
        assert (ours["epochs"], ours["batch_size"], ours["vis_batch_size"],
                ours["save_interval"], ours["checkpoint_interval"],
                ours["feature_maps_g"], ours["vgg_path"]) == \
            (50, 32, 32, 1000, 5, 32, "")
    else:
        assert ours["feature_maps_g"] == 32


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


def test_sampler_matches_the_jax_sampler(tmp_path):
    """A generator ``.pth`` written by the JAX package's codec, sampled by
    both packages: the JAX sampler with its own draws (per batch z, then
    labels), the port with those draws injected."""
    import jax
    from xgan.train.sample import generate_images as jax_generate
    from xgan_torch.train.sample import generate_images, load_generator
    g_model, _, (params, stats), _ = jax_cgan(LATENT, FM, SIZE, seed=3)
    pth = str(tmp_path / "generator_final.pth")
    save_torch_cgan_generator(pth, params, stats)
    n, batch, seed = 12, 8, 5  # 8: the test mesh's 8 CPU devices
    jax_generate(g_model, {"params": params, "batch_stats": stats},
                 output_dir=str(tmp_path / "jax"), num_images=n,
                 latent_dim=LATENT, batch_size=batch, seed=seed,
                 conditional=True, num_classes=2)
    noise, labels = [], []
    for k in range(2):
        kz, kl = jax.random.split(jax.random.fold_in(jax.random.key(seed), k))
        noise.append(np.array(jax.random.normal(kz, (batch, LATENT))))
        labels.append(np.array(jax.random.randint(kl, (batch,), 0, 2)))
    assert len(np.unique(np.concatenate(labels))) == 2
    g = load_generator(Generator(LATENT, 2, 3, FM, SIZE), pth)
    assert generate_images(g, output_dir=str(tmp_path / "port"),
                           num_images=n, latent_dim=LATENT, batch_size=batch,
                           device="cpu", dtype=torch.float32, noise=noise,
                           conditional=True, labels=labels) == n
    names, got = _read_pngs(tmp_path / "port")
    assert names == sorted(os.listdir(tmp_path / "jax"))
    want = _read_pngs(tmp_path / "jax")[1]
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert want.std() > 20  # the images span the u8 range


def test_sampler_draws_labels_from_the_seed(tmp_path):
    """Without injected draws each batch takes z, then its labels uniform
    over the model's ``num_classes``, from the seeded generator."""
    from xgan_torch.train.sample import generate_images
    seen = []

    class Spy(Generator):
        def forward(self, z, labels):
            seen.append((z.clone(), labels.clone()))
            return super().forward(z, labels)

    g = Spy(LATENT, 3, 3, FM, SIZE,
            generator=torch.Generator().manual_seed(0))
    assert generate_images(g, output_dir=str(tmp_path), num_images=5,
                           latent_dim=LATENT, batch_size=4, seed=7,
                           device="cpu", dtype=torch.float32,
                           conditional=True) == 5
    assert sorted(os.listdir(tmp_path)) == [f"synthetic_{i:05d}.png"
                                            for i in range(1, 6)]
    gen = torch.Generator().manual_seed(7)
    for z, labels in seen:
        torch.testing.assert_close(z, torch.randn((4, LATENT), generator=gen),
                                   rtol=0, atol=0)
        torch.testing.assert_close(labels, torch.randint(0, 3, (4,),
                                                         generator=gen),
                                   rtol=0, atol=0)
    assert len(torch.unique(torch.cat([y for _, y in seen]))) == 3


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
    _, _, (params, stats), _ = jax_cgan(LATENT, FM, SIZE, seed=4)
    pth = str(tmp_path / "generator_final.pth")
    save_torch_cgan_generator(pth, params, stats)
    msgpack = str(tmp_path / "generator_final.msgpack")
    save_variables(msgpack, {"params": params, "batch_stats": stats})
    for path, out in ((msgpack, "out"), (pth, "twin")):
        sample_cli.main(["--cpu", "--model-path", path, "--output-dir",
                         str(tmp_path / out), "--num-images", "5",
                         "--batch-size", "2", *MODEL_FLAGS])
    names, imgs = _read_pngs(tmp_path / "out")
    assert len(names) == 5 and imgs.std() > 20
    assert np.array_equal(imgs, _read_pngs(tmp_path / "twin")[1])


@pytest.mark.parametrize("missing", [None, "D_losses_epoch",
                                     "G_losses_epoch"])
def test_loss_figure_matches_jax(missing, tmp_path, capsys, monkeypatch):
    """The JAX writer's file name (or, with a series missing, its warning
    and no file); two panels stacked, each with its two series in the two
    default colours at alpha 0.8."""
    import matplotlib.pyplot as plt
    from xgan.io_ import figures as jax_figures
    from xgan_torch.io_ import figures, plots
    monkeypatch.setattr(plt, "savefig", lambda path, **_: open(
        path, "wb").close())
    rng = np.random.default_rng(0)
    history = {"G_losses_epoch": list(rng.random(6) + 3),
               "D_losses_epoch": list(rng.random(6)),
               "perceptual_losses": list(rng.random(6) + 10),
               "feature_matching_losses": list(rng.random(6) + 1)}
    if missing:
        history[missing] = []
    for name, mod in (("port", figures), ("jax", jax_figures)):
        (tmp_path / name).mkdir()
        mod.plot_cgan_losses(history, str(tmp_path / name
                                          / "cgan_loss_curve.png"))
    ours = sorted(os.listdir(tmp_path / "port"))
    assert ours == sorted(os.listdir(tmp_path / "jax"))
    assert ours == ([] if missing else ["cgan_loss_curve.png"])
    assert capsys.readouterr().out.count("loss data missing") == \
        (2 if missing else 0)
    if missing:
        return
    img = decode_png(str(tmp_path / "port" / "cgan_loss_curve.png"))
    assert img.shape == (600, 1200, 3)
    for panel in (img[:300], img[300:]):
        # a frame of its own: a black row across most of the width
        assert ((panel == 0).all(-1).sum(1) > 900).sum() >= 2
        for color in plots.CYCLE[:2]:
            want = np.round(0.2 * 255 + 0.8 * plots.rgb(color))
            assert (np.abs(panel.astype(int) - want).max(-1) <= 1).any()
