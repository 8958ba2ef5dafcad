"""``python -m xgan_torch.cli.train_gan --cpu`` on the fixture dataset
(24 images at 32 px, batch 16, so the second batch of each epoch is a
masked tail; 2 epochs; tiny widths): the history has the JAX schema and
``epochs * ceil(24 / 16)`` finite entries per iteration series, the
sample sheets decode to the expected grid, the checkpoints load strictly
(the final generator also into the JAX package and the port's sampler)
beside the run's snapshot, the loop flags the port supports pass its
refusal and the flags it does not support exit 1. Beside the run: the
sheet transform, the real-batch preprocessing, the sheet layout and the
loop's cadence against the JAX package's, and the progress line."""
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from xgan.models.pretrained import load_torch_gan_generator
from xgan_torch import kernels
from xgan_torch.cli import generate_synthetic
from xgan_torch.cli import train_gan as cli
from xgan_torch.models.dcgan import Discriminator, Generator
from xgan_torch.native.png import decode_png

torch.set_num_threads(1)

SIZE, B, EPOCHS, FM, LATENT, VIS = 32, 16, 2, 8, 16, 10
# the JAX trainer's history keys (tests/test_schema_compat.py)
HISTORY_KEYS = {"G_losses_iter", "D_losses_iter", "D_x_iter",
                "D_G_z1_iter", "D_G_z2_iter", "G_losses_epoch",
                "D_losses_epoch"}
MODEL_FLAGS = ["--image-size", str(SIZE), "--feature-maps-g", str(FM),
               "--latent-dim", str(LATENT)]


def _jax_parser():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "train_gan.py")
    spec = importlib.util.spec_from_file_location("jax_train_gan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_parser()


@pytest.fixture(scope="module")
def run(tmp_path_factory, fake_dataset):
    out = tmp_path_factory.mktemp("gan")
    argv = ["--cpu", "--data-dir", fake_dataset["data_dir"],
            "--model-dir", str(out / "models"),
            "--output-dir", str(out / "results"),
            "--results-dir", str(out / "metrics"),
            "--figures-dir", str(out / "figures"),
            "--cache-dir", str(out / "cache"), *MODEL_FLAGS,
            "--feature-maps-d", str(FM), "--epochs", str(EPOCHS),
            "--batch-size", str(B), "--vis-batch-size", str(VIS),
            "--save-interval", "3", "--checkpoint-interval", "1"]
    kernels.reset_launch_counts()
    history = cli.main(argv)
    assert sum(kernels.LAUNCHES.values()) == 0  # the CPU runs no kernel
    return history, out, fake_dataset["n_train"]


def test_history_has_the_reference_schema(run):
    history, out, n = run
    saved = json.loads((out / "metrics" / "gan_training_history.json")
                       .read_text())
    assert set(saved) == HISTORY_KEYS and saved == history
    steps = EPOCHS * math.ceil(n / B)
    for key in HISTORY_KEYS:
        want = steps if key.endswith("_iter") else EPOCHS
        assert len(saved[key]) == want, key
        assert np.isfinite(saved[key]).all(), key
    assert 0 < min(saved["D_x_iter"]) and max(saved["D_x_iter"]) < 1


def test_sample_sheets_decode(run):
    _, out, n = run
    sheets = sorted(os.listdir(out / "results" / "gan_images"))
    # iterations 0 and 3 (--save-interval 3), and the last (3) again
    assert sheets == ["fake_samples_epoch_001_iter_000000.png",
                      "fake_samples_epoch_002_iter_000003.png"]
    rows = math.ceil(VIS / 8)
    for name in sheets:
        img = decode_png(str(out / "results" / "gan_images" / name))
        assert img.shape == (rows * (SIZE + 2) + 2, 8 * (SIZE + 2) + 2, 3)
        assert (img[:2] == 255).all() and (img[:, :2] == 255).all()


def test_checkpoints_load_strictly(run, tmp_path, capsys):
    _, out, _ = run
    gan_dir = out / "models" / "gan"
    names = sorted(os.listdir(gan_dir))
    assert names == sorted(
        [f"{m}_epoch_{e:03d}.pth" for m in ("generator", "discriminator")
         for e in (1, 2)] + ["generator_final.pth",
                             "discriminator_final.pth", "snapshot_last.pth"])
    snap = torch.load(gan_dir / "snapshot_last.pth", weights_only=True)
    assert set(snap) == {"g", "d", "opt_g", "opt_d", "rng", "epoch",
                         "iters"}
    assert snap["epoch"] == 2
    for name in names[:-1]:
        sd = torch.load(gan_dir / name, weights_only=True)
        model = (Generator(LATENT, 3, FM, SIZE) if name.startswith("gen")
                 else Discriminator(3, FM, SIZE))
        model.load_state_dict(sd, strict=True)
    params, stats = load_torch_gan_generator(str(gan_dir /
                                                 "generator_final.pth"))
    assert params["ConvTranspose_5"]["kernel"].shape == (4, 4, FM // 2, 3)
    stats = generate_synthetic.main([
        "--cpu", "--model-path", str(gan_dir / "generator_final.pth"),
        "--output-dir", str(tmp_path / "synth"), "--num-images", "3",
        "--batch-size", "2", *MODEL_FLAGS])
    assert stats["written"] == 3
    img = decode_png(str(tmp_path / "synth" / "synthetic_00003.png"))
    assert img.shape == (SIZE, SIZE, 3)


def test_flags_and_defaults_follow_the_jax_cli():
    ours = {a.dest: a.default for a in cli.build_parser()._actions}
    theirs = {a.dest: a.default for a in _jax_parser()._actions}
    assert set(theirs) <= set(ours)
    for dest, default in theirs.items():
        if dest not in ("cpu", "help"):
            assert ours[dest] == default, dest


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
                                  ["--grad-accum", "2"],
                                  ["--steps-per-call", "2"],
                                  ["--trace-dir", "t"],
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
    with pytest.raises(SystemExit) as e:
        cli.main(["--data-dir", str(tmp_path)])
    assert e.value.code == 1
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("Error:"), last


def test_missing_dataset_returns_none(tmp_path, capsys):
    assert cli.main(["--cpu", "--data-dir", str(tmp_path / "none"),
                     "--model-dir", str(tmp_path / "m"),
                     "--output-dir", str(tmp_path / "o"),
                     "--results-dir", str(tmp_path / "r"),
                     "--figures-dir", str(tmp_path / "f")]) is None
    text = capsys.readouterr().out
    assert "Dataset not found" in text and "Error:" in text


def test_loss_curve_figure(run):
    """gan_loss_curve.png, as the JAX trainer writes it after the
    history."""
    _, out, _ = run
    assert os.listdir(out / "figures") == ["gan_loss_curve.png"]
    img = decode_png(str(out / "figures" / "gan_loss_curve.png"))
    assert img.shape == (600, 1200, 3) and img.std() > 0


def test_default_directories_land_in_the_working_directory(
        tmp_path, monkeypatch, capsys):
    """Without the path flags the trainer makes the reference's
    ./models, ./results/{gan_images,metrics,figures} where it runs."""
    monkeypatch.chdir(tmp_path)
    assert cli.main(["--cpu", "--data-dir", "none"]) is None
    assert "Dataset not found" in capsys.readouterr().out
    assert sorted(p.relative_to(tmp_path).as_posix()
                  for p in tmp_path.rglob("*")) == [
        "models", "models/gan", "results", "results/figures",
        "results/gan_images", "results/metrics"]


def test_minmax_to_u8_and_gather_preprocess_match_jax():
    """The sheet transform bitwise, and the GAN's real batch (take, flip,
    ImageNet-normalize) within 1e-6, with JAX's flip draws injected."""
    import jax
    import jax.numpy as jnp
    from xgan.data import pipeline as jax_pipeline
    from xgan_torch.data.pipeline import gather_preprocess, minmax_to_u8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 8, 8, 3)).astype(np.float32) * 3
    x[0, 0, 0, 0] = 0.5 / 255  # a value on a rounding boundary
    np.testing.assert_array_equal(
        minmax_to_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jax_pipeline.minmax_to_u8(jnp.asarray(x))))
    assert minmax_to_u8(torch.zeros(2, 4, 4, 3)).max() == 0  # flat sheet

    store = rng.integers(0, 255, (10, 8, 8, 3), np.uint8)
    idx = np.array([3, 0, 9, 3], np.int32)
    key = jax.random.key(1)
    want = jax_pipeline.gather_preprocess(jnp.asarray(store),
                                          jnp.asarray(idx), key, train=True)
    flip = torch.from_numpy(np.array(jax.random.bernoulli(key, 0.5, (4,))))
    got = gather_preprocess(torch.from_numpy(store),
                            torch.from_numpy(idx).long(), flip=flip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("b", [1, 8, 10])
def test_save_image_grid_matches_jax(tmp_path, b):
    from xgan.io_.figures import save_image_grid as jax_grid
    from xgan_torch.io_.figures import save_image_grid
    imgs = np.random.default_rng(b).integers(0, 255, (b, 6, 6, 3), np.uint8)
    save_image_grid(imgs, str(tmp_path / "port.png"))
    jax_grid(imgs, str(tmp_path / "jax.png"))
    np.testing.assert_array_equal(decode_png(str(tmp_path / "port.png")),
                                  decode_png(str(tmp_path / "jax.png")))


def test_loop_helpers():
    from xgan_torch.train.loop_common import (checkpoint_boundary,
                                              grid_iters)
    # the JAX loop's cadence at one step per dispatch
    from xgan.train.loop_common import grid_iters as jax_grid_iters
    for iters in range(12):
        for last in (False, True):
            i = iters % 4
            assert grid_iters(iters, 1, 5, last, i, 4) == jax_grid_iters(
                iters, 1, 5, last, i, 4)

    class Running:
        requested = False

    saved = []
    for e in range(7):
        assert not checkpoint_boundary(Running(), e, 7, 3,
                                       lambda: saved.append(e))
    assert saved == [2, 5, 6]


def test_progress_line_shows_fetched_metrics(monkeypatch, capsys):
    """On a terminal the progress line shows a step's metrics once their
    copy to the host has landed (on the CPU: at the next redraw)."""
    from xgan_torch.train.loop_common import EpochProgress, \
        gan_live_postfix
    with EpochProgress("Epoch 1/1", 3, postfix_fn=gan_live_postfix) as p:
        p.enabled = True
        for i in range(3):
            p._last = 0.0  # no redraw throttling in the test
            p.update(i + 1, torch.tensor([0.5, 1.25, 0.75, 0.1, 0.2]) * i)
    out = capsys.readouterr().out
    assert "3/3 batches dispatched" in out
    assert "Loss_D: 1.2500, Loss_G: 0.5000, D(x): 0.7500" in out
