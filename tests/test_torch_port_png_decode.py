"""xgan_torch's PNG decode of every kind of PNG against the JAX package's
two readers (fault C5: the port refused what ``xgan`` reads and stored it
as black).

Parametrised over colour type x bit depth x interlace x row filter,
with PNGs written here with numpy and zlib (``chip_smoke.png_bytes``):

- the store's decode (``decode_png``, libpng's conversions) bitwise
  against ``xgan.data.store``'s native libpng decoder, through both
  stores at the images' own size (no resize), and never black;
- the analyzer's loaders (``load_rgb``, ``grey_u8``) bitwise against
  PIL's ``convert("RGB")`` and ``convert("L")``, as ``xgan/analysis.py``
  calls them (16-bit grey clipped at 255, not its high byte);
- the plain unfilter against a byte-by-byte reading of the PNG
  specification at every bytes-per-pixel 1-8.

The compiled unfilter needs the card's toolchain; its tests are in
``tests/test_torch_port_cuda.py`` (marked ``cuda``).
"""
import numpy as np
import pytest
import torch
from PIL import Image

from chip_smoke import PNG_CHANNELS, png_bytes
from xgan import native
from xgan.data.store import ImageStore as JaxImageStore
from xgan_torch.analysis import grey_u8, load_rgb
from xgan_torch.data.store import ImageStore
from xgan_torch.native import png
from xgan_torch.native.png import _unfilter, decode_png

torch.set_num_threads(1)

DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
KINDS = [(c, d) for c, ds in DEPTHS.items() for d in ds]
SIZE = 19  # odd: partial bytes below 8 bits, every Adam7 pass present


def _write(tmp_path, ctype, depth, interlace, filt, seed=0):
    """A SIZE x SIZE PNG with random samples, every row filtered with
    ``filt`` (or 0-4 in turn for None)."""
    rng = np.random.default_rng(seed + 31 * ctype + depth)
    ch = PNG_CHANNELS[ctype]
    hi = min(1 << depth, 11) if ctype == 3 else 1 << depth
    samples = rng.integers(0, hi, (SIZE, SIZE, ch))
    palette = rng.integers(0, 256, (11, 3)) if ctype == 3 else None
    path = str(tmp_path / f"c{ctype}d{depth}i{int(interlace)}f{filt}.png")
    with open(path, "wb") as f:
        f.write(png_bytes(samples, ctype, depth, interlace=interlace,
                          filters=(0, 1, 2, 3, 4) if filt is None
                          else (filt,), palette=palette))
    return path


@pytest.fixture(scope="module", autouse=True)
def libpng():
    assert native._load(), "xgan's native libpng decoder must load"


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, None])
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", KINDS)
def test_store_decode_matches_libpng(tmp_path, ctype, depth, interlace,
                                     filt):
    path = _write(tmp_path, ctype, depth, interlace, filt)
    want = native.decode_png_batch([path], SIZE)[0]
    got = decode_png(path)
    assert got.dtype == np.uint8 and got.shape == (SIZE, SIZE, 3)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0  # not a black substitute
    ours = ImageStore.build([path], np.zeros(1, np.int32), SIZE)
    theirs = JaxImageStore.build([path], np.zeros(1, np.int32), SIZE)
    np.testing.assert_array_equal(ours.images, theirs.images)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("ctype,depth", KINDS)
def test_analyzer_loaders_match_pil(tmp_path, ctype, depth, interlace):
    path = _write(tmp_path, ctype, depth, interlace, None, seed=1)
    with Image.open(path) as im:
        rgb, grey = np.asarray(im.convert("RGB")), np.asarray(im.convert("L"))
    got = load_rgb(path)
    np.testing.assert_array_equal(got, rgb)
    np.testing.assert_array_equal(grey_u8(got), grey)


def test_sixteen_bit_grey_rules(tmp_path):
    """The two readers differ only on 16-bit grey: libpng keeps the high
    byte, PIL clips at 255; other 16-bit samples keep their high byte in
    both."""
    samples = np.array([[[0], [200], [255], [256], [4660], [65535]]])
    path = str(tmp_path / "g16.png")
    with open(path, "wb") as f:
        f.write(png_bytes(samples, 0, 16))
    np.testing.assert_array_equal(decode_png(path)[0, :, 0],
                                  [0, 0, 0, 1, 18, 255])
    np.testing.assert_array_equal(decode_png(path, grey16="clip")[0, :, 0],
                                  [0, 200, 255, 255, 255, 255])
    rgb = np.repeat(samples, 3, axis=2)
    path = str(tmp_path / "rgb16.png")
    with open(path, "wb") as f:
        f.write(png_bytes(rgb, 2, 16))
    np.testing.assert_array_equal(decode_png(path, grey16="clip"),
                                  decode_png(path))
    with pytest.raises(ValueError):
        decode_png(path, grey16="low")


def _spec_unfilter(raw, h, stride, bpp):
    """The PNG specification's reconstruction, one byte at a time."""
    out = [[0] * stride for _ in range(h + 1)]
    for y in range(h):
        kind = int(raw[y, 0])
        for i in range(stride):
            a = out[y + 1][i - bpp] if i >= bpp else 0
            b = out[y][i]
            c = out[y][i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else c)
            out[y + 1][i] = (int(raw[y, 1 + i]) + pred) % 256
    return np.array(out[1:], np.uint8).reshape(h, stride)


@pytest.mark.parametrize("bpp", range(1, 9))
def test_plain_unfilter_every_bpp(bpp):
    rng = np.random.default_rng(bpp)
    for stride in (bpp, 3 * bpp, 5 * bpp + 3, 1):
        raw = rng.integers(0, 256, (10, 1 + stride), dtype=np.uint8)
        raw[:, 0] = np.arange(10) % 5
        np.testing.assert_array_equal(_unfilter(raw, 10, stride, bpp),
                                      _spec_unfilter(raw, 10, stride, bpp))
    raw[4, 0] = 5
    with pytest.raises(ValueError, match="row filter 5"):
        _unfilter(raw, 10, stride, bpp)


def test_store_counts_the_plain_unfilter_on_the_cpu(tmp_path, monkeypatch):
    """A CPU build decodes with the plain version, one call a (sub-)image:
    seven for an Adam7 image of this size."""
    plain = _write(tmp_path, 2, 8, False, 4)
    inter = _write(tmp_path, 2, 8, True, 4)
    routes, inner = [], png.unfilter

    def counted(*args, compiled=False, **kw):
        routes.append(compiled)
        return inner(*args, compiled=compiled, **kw)
    monkeypatch.setattr(png, "unfilter", counted)
    ImageStore.build([plain, inter], np.zeros(2, np.int32), SIZE)
    assert routes == [False] * (1 + 7)
