"""The stdlib PNG reader and writer (yaik_tpu.utils.png) against PIL on
every fixture PNG, on each of the five scanline filters, and through a
write/read round trip per color type."""
import zlib

import numpy as np
import pytest
from PIL import Image

from tests.conftest import FIXTURES
from yaik_tpu.utils import png


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        FIXTURES.glob("*.png")))
def test_read_png_matches_pil(name):
    got = png.read_png(FIXTURES / name)
    pil = Image.open(FIXTURES / name)
    assert np.array_equal(got, np.asarray(pil))
    assert np.array_equal(png.read_png(FIXTURES / name, rgb=True),
                          np.asarray(pil.convert("RGB")))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decode_each_filter(ftype):
    """Rows filtered with one filter type (PNG spec 9.2, forward filters
    computed from the unfiltered image) decode to the image."""
    rng = np.random.default_rng(ftype)
    h, w, ch = 9, 13, 3
    img = rng.integers(0, 256, (h, w, ch)).astype(np.uint8)
    x = img.reshape(h, w * ch).astype(np.int64)
    a = np.pad(x, ((0, 0), (ch, 0)))[:, :-ch]          # left
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]               # up
    c = np.pad(b, ((0, 0), (ch, 0)))[:, :-ch]          # up-left
    pred = [0 * x, a, b, (a + b) >> 1, _paeth(a, b, c)][ftype]
    filt = ((x - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((h, 1), ftype, np.uint8), filt], axis=1)
    data = (png.SIGNATURE
            + png._chunk(b"IHDR", np.array([w, h], ">u4").tobytes()
                         + bytes([8, 2, 0, 0, 0]))
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + png._chunk(b"IEND", b""))
    assert np.array_equal(png.decode_png(data), img)


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (5, 7, 4)])
def test_write_png_round_trip(shape, tmp_path):
    img = np.random.default_rng(len(shape)).integers(
        0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    png.write_png(path, img)
    assert np.array_equal(png.read_png(path), img)
    assert np.array_equal(np.asarray(Image.open(path)), img)
