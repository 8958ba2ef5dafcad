"""xgan_torch's sampler and its CLI against the JAX package's.

PNGs are decoded with PIL and held within 1 u8 level of JAX's
tanh_to_u8(model.apply(...)) for the same injected z, with at most 0.1 %
of pixels differing (f32 on both sides; the BN fold reorders f32
arithmetic, which can move a value across a rounding boundary)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.torch_port_util import jax_generator
from xgan.data.pipeline import tanh_to_u8 as jax_tanh_to_u8
from xgan.models.pretrained import save_torch_gan_generator
from xgan_torch.cli import generate_synthetic
from xgan_torch.data.pipeline import tanh_to_u8
from xgan_torch.models.convert import generator_state_dict_from_jax
from xgan_torch.models.dcgan import Generator
from xgan_torch.native.png import decode_png, encode_png_batch
from xgan_torch.train.sample import generate_images

torch.set_num_threads(1)

LATENT, FG, SIZE = 16, 8, 32


def _read(out_dir):
    names = sorted(os.listdir(out_dir))
    return names, np.stack([np.asarray(Image.open(os.path.join(out_dir, n)))
                            for n in names])


def _cli_args(tmp_path, pth, *extra):
    return ["--model-path", pth, "--output-dir", str(tmp_path / "out"),
            "--latent-dim", str(LATENT), "--feature-maps-g", str(FG),
            "--image-size", str(SIZE), *extra]


@pytest.fixture(scope="module")
def jax_gen():
    return jax_generator(LATENT, FG, SIZE, seed=11)


@pytest.fixture
def pth(tmp_path, jax_gen):
    _, params, stats = jax_gen
    path = str(tmp_path / "generator_final.pth")
    save_torch_gan_generator(path, params, stats)
    return path


def test_pngs_match_jax_for_injected_z(tmp_path, jax_gen):
    model, params, stats = jax_gen
    rng = np.random.default_rng(12)
    noise = [rng.normal(size=(4, LATENT)).astype(np.float32)
             for _ in range(2)]
    g = Generator(LATENT, 3, FG, SIZE)
    g.load_state_dict(generator_state_dict_from_jax(params, stats))
    stats_out = {}
    n = generate_images(g, output_dir=str(tmp_path), num_images=8,
                        latent_dim=LATENT, batch_size=4, seed=0,
                        device="cpu", dtype=torch.float32, noise=noise,
                        stats=stats_out)
    assert n == 8 and stats_out["imgs_per_sec"] > 0
    names, got = _read(tmp_path)
    assert names == [f"synthetic_{i:05d}.png" for i in range(1, 9)]
    want = np.concatenate([np.asarray(jax_tanh_to_u8(model.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(z),
        train=False))) for z in noise])
    assert got.shape == want.shape == (8, SIZE, SIZE, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    assert want.std() > 20  # the images span the u8 range


def test_tail_batch_writes_exactly_num_images(tmp_path, jax_gen):
    _, params, stats = jax_gen
    g = Generator(LATENT, 3, FG, SIZE)
    g.load_state_dict(generator_state_dict_from_jax(params, stats))
    n = generate_images(g, output_dir=str(tmp_path), num_images=7,
                        latent_dim=LATENT, batch_size=3, seed=5,
                        device="cpu", dtype=torch.float32)
    names, imgs = _read(tmp_path)
    assert n == 7 and names == [f"synthetic_{i:05d}.png"
                                for i in range(1, 8)]
    # seeded draws: a second run writes the same images
    n2 = generate_images(g, output_dir=str(tmp_path / "again"),
                         num_images=7, latent_dim=LATENT, batch_size=3,
                         seed=5, device="cpu", dtype=torch.float32)
    assert n2 == 7 and np.array_equal(_read(tmp_path / "again")[1], imgs)


def test_injected_noise_that_runs_out_raises(tmp_path):
    g = Generator(LATENT, 3, FG, SIZE)
    with pytest.raises(ValueError, match="noise ran out"):
        generate_images(g, output_dir=str(tmp_path), num_images=5,
                        latent_dim=LATENT, batch_size=4, device="cpu",
                        dtype=torch.float32,
                        noise=[np.zeros((4, LATENT), np.float32)])


def test_cli_runs_end_to_end_on_cpu(tmp_path, pth):
    stats = generate_synthetic.main(_cli_args(
        tmp_path, pth, "--num-images", "5", "--batch-size", "2", "--cpu"))
    names, imgs = _read(tmp_path / "out")
    assert stats["written"] == 5 and len(names) == 5
    assert imgs.shape == (5, SIZE, SIZE, 3)


def test_cli_missing_checkpoint_exits_1(tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        generate_synthetic.main(_cli_args(
            tmp_path, str(tmp_path / "nope.pth"), "--cpu"))
    assert e.value.code == 1
    assert "Error: Generator model not found at" in capsys.readouterr().out


def test_cli_flag_mismatch_exits_1(tmp_path, pth, capsys):
    with pytest.raises(SystemExit) as e:
        generate_synthetic.main(_cli_args(tmp_path, pth, "--cpu")
                                + ["--feature-maps-g", "16"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "Error loading generator checkpoint" in out
    assert "--latent-dim/--feature-maps-g/--image-size" in out


@pytest.mark.parametrize("ext", [".msgpack", ".stablehlo"])
def test_cli_unsupported_formats_exit_1(tmp_path, capsys, jax_gen, pth, ext):
    """.stablehlo needs JAX and exits 1; a .msgpack of the JAX package
    samples the images of its .pth twin."""
    if ext == ".stablehlo":
        with pytest.raises(SystemExit) as e:
            generate_synthetic.main(_cli_args(
                tmp_path, str(tmp_path / f"g{ext}"), "--cpu"))
        assert e.value.code == 1
        assert "not supported by xgan_torch" in capsys.readouterr().out
        return
    from xgan.io_.checkpoint import save_variables
    _, params, stats = jax_gen
    msgpack = str(tmp_path / "generator_final.msgpack")
    save_variables(msgpack, {"params": params, "batch_stats": stats})
    for path, out in ((msgpack, "out"), (pth, "twin")):
        generate_synthetic.main(["--model-path", path, "--output-dir",
                                 str(tmp_path / out), "--latent-dim",
                                 str(LATENT), "--feature-maps-g", str(FG),
                                 "--image-size", str(SIZE), "--num-images",
                                 "5", "--batch-size", "2", "--cpu"])
    names, imgs = _read(tmp_path / "out")
    assert len(names) == 5 and np.array_equal(imgs,
                                              _read(tmp_path / "twin")[1])


def test_cli_without_cpu_flag_refuses_to_run_on_cpu(tmp_path, pth, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks CUDA-less hosts")
    with pytest.raises(SystemExit) as e:
        generate_synthetic.main(_cli_args(tmp_path, pth))
    assert e.value.code != 0
    assert capsys.readouterr().out.startswith("Error: ")
    assert not (tmp_path / "out").exists()


def test_cli_defaults_match_reference_cli():
    args = generate_synthetic.build_parser().parse_args(
        ["--model-path", "g.pth"])
    assert (args.output_dir, args.num_images, args.latent_dim,
            args.feature_maps_g, args.batch_size, args.image_size,
            args.seed, args.cpu, args.compute_dtype) == (
        "./data/synthetic", 5000, 100, 64, 64, 224, 0, False, "auto")


def test_png_writer_decodes_bit_exactly(tmp_path):
    rng = np.random.default_rng(13)
    imgs = rng.integers(0, 256, (3, 17, 29, 3), dtype=np.uint8)
    imgs[1] = 7  # a flat image compresses to almost nothing
    paths = [str(tmp_path / f"{i}.png") for i in range(3)]
    assert encode_png_batch(imgs, paths) == 0
    for img, p in zip(imgs, paths):
        with Image.open(p) as im:
            assert im.mode == "RGB" and im.size == (29, 17)
            assert np.array_equal(np.asarray(im), img)
        assert np.array_equal(decode_png(p), img)


def test_png_writer_counts_failures(tmp_path):
    imgs = np.zeros((2, 4, 4, 3), np.uint8)
    paths = [str(tmp_path / "ok.png"), str(tmp_path / "missing" / "x.png")]
    assert encode_png_batch(imgs, paths) == 1
    assert os.path.exists(paths[0])


def test_tanh_to_u8_matches_jax():
    x = np.concatenate([np.linspace(-1.2, 1.2, 1001),
                        # k/255 boundaries land exactly on .5: half to even
                        (np.arange(256) + 0.5) / 255 * 2 - 1]
                       ).astype(np.float32)
    want = np.asarray(jax_tanh_to_u8(jnp.asarray(x)))
    assert np.array_equal(tanh_to_u8(torch.from_numpy(x)).numpy(), want)
