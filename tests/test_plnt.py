"""DynamicTileEncode (PLNT) parity: byte-exact streams vs the compiled
reference pass (EncoderContext.cpp:4365-4602, disabled `#if 0` at
:9539-9545; goldens from tools/ref_encode_plnt_main.cpp) and standalone
reconstruction semantics."""
import struct

import numpy as np
import pytest
from PIL import Image

from tests.conftest import FIXTURES
from yaik_tpu.decoder import reference as decref
from yaik_tpu.decoder.reference import iter_chunks
from yaik_tpu.encoder import plnt
from yaik_tpu.entropy import zstd_backend as zstd
from yaik_tpu.format.headers import (FileHeader, MAGIC, HeaderBase,
                                     PlaneTile)
from yaik_tpu.ops import plane as ops


def _load(name):
    rgb = np.asarray(Image.open(FIXTURES / f"{name}.png").convert("RGB"))
    return rgb, rgb.transpose(2, 0, 1).astype(np.int32)


def _plnt_payloads(stream: bytes):
    """Each PLNT chunk with its zstd sections decompressed: (header fields
    except the two compressed sizes, tile types, tile indices). Two zstd
    builds compress the same input to different bytes, so this is what
    byte-exactness means without the reference's zstd 1.3.4."""
    out = []
    for tag, off, body in iter_chunks(stream):
        hdr = PlaneTile.unpack(body)
        z0 = PlaneTile.size()
        z1 = z0 + hdr.stream_size_tile_map
        types = zstd.decompress(body[z0:z1], zstd.frame_content_size(
            body[z0:z1]))
        idx = zstd.decompress(body[z1:z1 + hdr.stream_size_tile_stream],
                              hdr.expected_size_tile_stream)
        out.append((tag, hdr.x, hdr.y, hdr.w, hdr.h,
                    hdr.expected_size_tile_stream, hdr.version, hdr.format,
                    types, idx))
    return out


@pytest.mark.parametrize("name", ["img64", "corr2d128"])
def test_plnt_byte_exact(name):
    rgb, planes = _load(name)
    h, w = rgb.shape[:2]
    mine = (FileHeader(MAGIC, 1, w, h, 0).pack()
            + plnt.encode_plnt(planes, None, (0, 0, w, h))
            + struct.pack("<I", 0xDEADBEEF))
    gold = (FIXTURES / f"{name}.plnt.yaik").read_bytes()
    if zstd.IS_REFERENCE_ZSTD:
        assert mine == gold
    else:
        assert mine[:FileHeader.size()] == gold[:FileHeader.size()]
        assert _plnt_payloads(mine) == _plnt_payloads(gold)


def test_plnt_table_roundtrip():
    """Range coding: base/rng survive the encode half; decode reproduces
    the exact curve tables (curves_from is shared by both sides)."""
    for mn, mx in [(0, 255), (10, 40), (229, 239), (100, 116), (0, 0)]:
        base, rng, luts = plnt.build_table(mn, mx)
        bn = plnt.min_range_decode(base)
        dist = plnt.diff_range_decode(rng, bn)
        assert plnt.curves_from(bn, dist) == luts


def test_plnt_standalone_reconstruction():
    """decode_plnt_plane rebuilds the Y plane within the chosen curve's
    quantization error of the source (Y is unsigned, so the stream's
    missing sign bit does not bite)."""
    rgb, planes = _load("img64")
    h, w = rgb.shape[:2]
    yy, _, _ = ops.rgb_to_ycocg(planes[0], planes[1], planes[2])
    gold = (FIXTURES / "img64.plnt.yaik").read_bytes()
    # first chunk is the Y plane
    hb = HeaderBase.unpack(gold, 12)
    hdr = PlaneTile.unpack(gold, 20)
    assert (hdr.format >> 2) == 0 and hdr.version == 1
    body = gold[20 + PlaneTile.size():20 + hb.length]
    plane, n_tiles = decref.decode_plnt_plane(hdr, body)
    assert n_tiles == (w // 8) * (h // 8)
    sel = plane != -999
    assert sel.all()   # all-valid mask -> every pixel coded
    err = np.abs(plane[: h, : w] - yy)
    # range coding: BN quantization + curve steps; bounded, not exact
    assert float(np.median(err)) <= 16
    assert err.mean() < 16


@pytest.mark.slow
def test_plnt_in_pipeline(lut_bytes):
    """enable_plnt appends Y/Co/Cg PLNT chunks after 1DTL; decode is
    unchanged (the chunk is validated and skipped, like the reference
    decoder's deprecated-tag handling)."""
    from yaik_tpu.encoder import bank as bankmod
    from yaik_tpu.encoder.context import EncoderConfig, encode_image
    rgb, _ = _load("img64")
    bank = bankmod.load_bank(str(FIXTURES / "Bank3D"))
    s = encode_image(rgb, bank, EncoderConfig(enable_plnt=True))
    tags = [t for t, _, _ in decref.iter_chunks(s)]
    assert tags.count(b"PLNT") == 3
    assert tags.index(b"PLNT") > tags.index(b"1DTL")
    out = decref.decode(s, lut_bytes)
    base = decref.decode(encode_image(rgb, bank), lut_bytes)
    assert np.array_equal(out, base)


@pytest.mark.slow
def test_plnt_jax_engine(lut_bytes):
    from yaik_tpu.decoder import api
    from yaik_tpu.encoder import bank as bankmod
    from yaik_tpu.encoder.context import EncoderConfig, encode_image
    rgb, _ = _load("img64")
    bank3 = bankmod.load_bank(str(FIXTURES / "Bank3D"))
    s = encode_image(rgb, bank3, EncoderConfig(enable_plnt=True,
                                               enable_smooth_map=True))
    bank = api.assign_lut(lut_bytes)
    host = api.decode_image(s, bank, engine="host")
    dev = api.decode_image(s, bank, engine="jax")
    assert np.array_equal(host, dev)


@pytest.mark.parametrize("name", ["img64", "corr2d128"])
def test_plnt_device_plane_matches_host(name):
    """The device PLNT plane reconstruction (jax_engine.plnt_device_args +
    decode_plnt_plane_device) is pixel-identical to the host standalone
    decoder on every PLNT chunk of the golden streams."""
    from yaik_tpu.decoder import jax_engine
    data = (FIXTURES / f"{name}.plnt.yaik").read_bytes()
    n = 0
    for tag, _, body in decref.iter_chunks(data):
        if tag != b"PLNT":
            continue
        hdr = PlaneTile.unpack(body)
        pb = body[PlaneTile.size():]
        host_plane, _ = decref.decode_plnt_plane(hdr, pb)
        args = jax_engine.plnt_device_args(hdr, pb)
        assert args is not None
        luts, codes, vmask, nty, ntx = args
        dev = np.asarray(jax_engine.decode_plnt_plane_device(
            luts, codes, vmask, nty=nty, ntx=ntx))
        assert np.array_equal(dev, host_plane[hdr.y:hdr.y + hdr.h,
                                              hdr.x:hdr.x + hdr.w])
        n += 1
    assert n == 3     # Y, Co, Cg
