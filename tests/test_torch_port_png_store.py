"""xgan_torch's host data path against the JAX package's: the PNG
decoder against PIL (bitwise), the image store against
``xgan.data.store`` (within 1 u8 level: PIL's BILINEAR and torch's
antialiased bilinear round differently), the CSV readers and
``epoch_batches`` (exactly)."""
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from xgan.data import rsna as jax_rsna
from xgan.data.pipeline import epoch_batches as jax_epoch_batches
from xgan.data.store import ImageStore as JaxImageStore
from xgan_torch.data import rsna
from xgan_torch.data.pipeline import (epoch_batches, normalize_images,
                                      random_flip)
from xgan_torch.data.store import ImageStore, decode_folder_store
from xgan_torch.native.png import decode_png, encode_png

torch.set_num_threads(1)


def _pil_rgb(path):
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _smooth(rng, h, w, c):
    """Smooth content, so PIL's encoder picks Up and Paeth rows too."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.sin(xx / 5.0) * 50 + np.cos(yy / 7.0) * 50 + 128
    img = base[..., None] + rng.normal(0, 4, (h, w, c))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("mode,channels", [("RGB", 3), ("L", 1),
                                           ("RGBA", 4), ("LA", 2)])
def test_decode_png_matches_pil(tmp_path, mode, channels):
    rng = np.random.default_rng(0)
    for i, img in enumerate([rng.integers(0, 255, (48, 37, channels),
                                          dtype=np.uint8),
                             _smooth(rng, 40, 53, channels)]):
        path = str(tmp_path / f"{mode}{i}.png")
        Image.fromarray(img[..., 0] if channels == 1 else img,
                        mode).save(path)
        np.testing.assert_array_equal(decode_png(path), _pil_rgb(path))


def test_decode_png_palette_and_fixture(tmp_path, fake_dataset):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "p.png")
    Image.fromarray(rng.integers(0, 255, (30, 30, 3), dtype=np.uint8)) \
        .convert("P", palette=Image.ADAPTIVE).save(path)
    np.testing.assert_array_equal(decode_png(path), _pil_rgb(path))
    folder = os.path.join(fake_dataset["data_dir"], "Training", "Images")
    for name in sorted(os.listdir(folder))[:4]:
        p = os.path.join(folder, name)
        np.testing.assert_array_equal(decode_png(p), _pil_rgb(p))


def _png(path, w, h, ctype, depth, rows, interlace=0):
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def test_decode_png_average_filter(tmp_path):
    """Rows filtered with Average (3) by hand; PIL decodes the same
    pixels."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 255, (6, 5, 3), dtype=np.uint8).astype(int)
    raw, prev = b"", np.zeros(15, int)
    for y in range(6):
        cur = img[y].reshape(-1)
        left = np.concatenate([np.zeros(3, int), cur[:-3]])
        raw += bytes([3]) + bytes(((cur - (left + prev) // 2) % 256)
                                  .astype(np.uint8))
        prev = cur
    path = str(tmp_path / "avg.png")
    _png(path, 5, 6, 2, 8, raw)
    np.testing.assert_array_equal(decode_png(path), img.astype(np.uint8))
    np.testing.assert_array_equal(decode_png(path), _pil_rgb(path))


def test_decode_png_rejects_what_it_cannot_read(tmp_path):
    p16, pint, bad = (str(tmp_path / n) for n in ("a.png", "b.png", "c.png"))
    _png(p16, 2, 2, 2, 16, bytes(2 * (1 + 12)))
    _png(pint, 2, 2, 2, 8, bytes(2 * 7), interlace=1)
    with open(bad, "wb") as f:
        f.write(b"not a png")
    for path in (p16, pint, bad):
        with pytest.raises(ValueError):
            decode_png(path)
    rng = np.random.default_rng(3)
    img = rng.integers(0, 255, (9, 11, 3), dtype=np.uint8)
    enc = str(tmp_path / "enc.png")
    with open(enc, "wb") as f:
        f.write(encode_png(img))
    np.testing.assert_array_equal(decode_png(enc), img)


def test_metadata_labels_match_jax(fake_dataset):
    d = fake_dataset["data_dir"]
    for ours, theirs, name in (
            (rsna.load_train_metadata, jax_rsna.load_train_metadata,
             "stage2_train_metadata.csv"),
            (rsna.load_test_metadata, jax_rsna.load_test_metadata,
             "stage2_test_metadata.csv")):
        ids, labels = ours(os.path.join(d, name))
        jids, jlabels = theirs(os.path.join(d, name))
        assert ids == jids
        assert labels.dtype == np.int32 and 0 < labels.sum() < len(labels)
        np.testing.assert_array_equal(labels, jlabels)
    assert rsna.check_dataset_availability(d, verbose=False)
    assert not rsna.check_dataset_availability(d + "_missing", verbose=False)
    assert rsna.train_paths(d, ["a"]) == jax_rsna.train_paths(d, ["a"])
    assert rsna.test_paths(d, ["a"]) == jax_rsna.test_paths(d, ["a"])


@pytest.mark.parametrize("size", [32, 64])
def test_store_within_one_level_of_jax(tmp_path, fake_dataset, size):
    d = fake_dataset["data_dir"]
    ids, labels = rsna.load_train_metadata(
        os.path.join(d, "stage2_train_metadata.csv"))
    paths = rsna.train_paths(d, ids) + [str(tmp_path / "missing.png")]
    labels = np.append(labels, 0)
    cache = str(tmp_path / "cache")
    ours = ImageStore.build(paths, labels, size, cache_dir=cache,
                            name="train")
    theirs = JaxImageStore.build(paths, labels, size)
    assert ours.images.shape == (len(paths), size, size, 3)
    diff = np.abs(ours.images.astype(int) - theirs.images.astype(int))
    assert diff.max() <= 1, diff.max()
    assert not ours.images[-1].any()  # missing file -> black image
    again = ImageStore.build(paths, labels, size, cache_dir=cache,
                             name="train")
    assert isinstance(again.images, np.memmap)  # the .npy cache was used
    np.testing.assert_array_equal(again.images, ours.images)


def test_folder_store(fake_dataset):
    store = decode_folder_store(fake_dataset["synthetic_dir"], 32)
    assert len(store) == fake_dataset["n_synth"]
    assert (store.labels == 1).all() and store.images.dtype == np.uint8


@pytest.mark.parametrize("n,b,shuffle,subset", [(24, 8, True, False),
                                                (23, 5, True, True),
                                                (10, 4, False, True),
                                                (7, 16, True, False)])
def test_epoch_batches_match_jax(n, b, shuffle, subset):
    indices = np.arange(0, 3 * n, 3) if subset else None
    ours = epoch_batches(n, b, np.random.default_rng(5), shuffle=shuffle,
                         indices=indices)
    theirs = jax_epoch_batches(n, b, np.random.default_rng(5),
                               shuffle=shuffle, indices=indices)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, theirs)


def test_flip_and_normalize_match_jax():
    from xgan.data.pipeline import normalize_images as jax_normalize
    rng = np.random.default_rng(6)
    u8 = rng.integers(0, 255, (4, 8, 8, 3), np.uint8)
    flip = np.array([True, False, True, False])
    got = random_flip(torch.from_numpy(u8), torch.from_numpy(flip))
    want = np.where(flip[:, None, None, None], u8[:, :, ::-1], u8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        normalize_images(torch.from_numpy(u8)).numpy(),
        np.asarray(jax_normalize(u8)))
