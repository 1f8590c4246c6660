"""The LUT resolve as an integer gather (T3, 2DTL, PLNT) against numpy
models with table words up to their format's full width, and the six 2DTL
passes (3 plane pairs x {8x8, 4x4}) against the host decoder on crafted
single-pass streams.

The gather replaces an f32 one-hot product, which a GPU may compute in
TF32 (10 mantissa bits): packed 24-bit words would round. These cases
pin exactness at words the product could not hold.
Reference semantics: YAIK_3DTile.cpp:965-1320 (3D), :2145-3809 (2D).
"""
import struct

import numpy as np
import pytest

import jax.numpy as jnp

from tests.conftest import FIXTURES
from yaik_tpu.decoder import jax_engine as je
from yaik_tpu.format import swizzle


def _tiles_to_image(v, nty, ntx, th, tw):
    return v.reshape(nty, ntx, th, tw).transpose(0, 2, 1, 3).reshape(
        nty * th, ntx * tw)


def _pass_model(plane, words, accept, colors, packed, nbytes, shifts, th,
                tw):
    """numpy model of one LUT size pass: per pixel the tile's table word at
    its index, per written byte min + ((max - min) * L) >> 7."""
    g = packed.shape[0]
    idx = packed.astype(np.int64) & 63
    w = np.take_along_axis(words, idx, axis=1)              # [g, npx]
    cols = colors.astype(np.int64)
    new = np.zeros_like(w)
    chmask = 0
    for k, sh in enumerate(shifts):
        L = (w >> (8 * k)) & 0xFF
        mn = cols[:, k:k + 1]
        d = cols[:, nbytes + k:nbytes + k + 1] - mn
        new |= ((mn + ((d * L) >> 7)) & 0xFF) << sh
        chmask |= 0xFF << sh
    write = ((packed >> 6) & 1).astype(bool) & accept.reshape(g, 1)
    nty, ntx = accept.shape
    new_img = _tiles_to_image(new, nty, ntx, th, tw)
    wr_img = _tiles_to_image(write, nty, ntx, th, tw)
    p = plane.astype(np.int64)
    return np.where(wr_img, (p & ~chmask) | new_img, p).astype(np.uint32)


def _rand_pass(rng, nty, ntx, th, tw, rows_n, word_bits, ncols):
    g = nty * ntx
    tab = rng.integers(0, 1 << word_bits, (rows_n, 64)).astype(np.int32)
    tab[0] = (1 << word_bits) - 1                # the widest word
    accept = rng.random((nty, ntx)) < 0.6
    rows = rng.integers(0, rows_n, g).astype(np.int32)
    colors = rng.integers(0, 256, (g, ncols)).astype(np.uint8)
    packed = (rng.integers(0, 64, (g, th * tw))
              | (rng.integers(0, 2, (g, th * tw)) << 6)).astype(np.uint8)
    plane = rng.integers(0, 1 << 24, (nty * th, ntx * tw)).astype(np.uint32)
    return plane, tab, accept, rows, colors, packed


@pytest.mark.parametrize("case", ["t3_layer4x4", "t3_pass16x8", "t2_rg",
                                  "t2_gb", "t2_rb", "plnt"])
def test_lut_resolve_matches_numpy(case):
    rng = np.random.default_rng(sum(map(ord, case)))
    if case == "plnt":
        T, nty, ntx = 12, 3, 4
        luts = rng.integers(0, 1 << 24, (T, 16)).astype(np.int32)
        luts[0] = (1 << 24) - 1
        codes = rng.integers(0, 16, (T, 64)).astype(np.int32)
        vmask = rng.random((T, 64)) < 0.8
        got = np.asarray(je.decode_plnt_plane_device(
            jnp.asarray(luts), jnp.asarray(codes), jnp.asarray(vmask),
            nty=nty, ntx=ntx))
        want = np.where(vmask, np.take_along_axis(luts, codes, axis=1), -999)
        assert np.array_equal(got, _tiles_to_image(want, nty, ntx, 8, 8))
        return
    if case.startswith("t3"):
        sx, sy = (2, 2) if case == "t3_layer4x4" else (4, 3)
        tw, th = 1 << sx, 1 << sy
        nty, ntx = 64 // th, 64 // tw
        plane, tab, accept, rows, colors, packed = _rand_pass(
            rng, nty, ntx, th, tw, 40, 24, 6)
        got = je._tile3d_pass(jnp.asarray(plane), jnp.asarray(tab),
                              jnp.asarray(accept), jnp.asarray(rows),
                              jnp.asarray(colors), jnp.asarray(packed),
                              sx, sy)
        want = _pass_model(plane, tab[rows].astype(np.int64), accept,
                           colors, packed, 3, (0, 8, 16), th, tw)
    else:
        mode = {"t2_rg": 0, "t2_gb": 1, "t2_rb": 2}[case]
        pa, pb = je._T2_PLANES[mode]
        nty = ntx = 8
        plane, tab, accept, rows, colors, packed = _rand_pass(
            rng, nty, ntx, 8, 8, 40, 16, 4)
        got = je._tile2d_pass(jnp.asarray(plane), jnp.asarray(tab),
                              jnp.asarray(accept), jnp.asarray(rows),
                              jnp.asarray(colors), jnp.asarray(packed),
                              mode, 3, 3)
        want = _pass_model(plane, tab[rows].astype(np.int64), accept,
                           colors, packed, 2, (8 * pa, 8 * pb), 8, 8)
    assert np.array_equal(np.asarray(got), want)


def _craft_t2_stream(w, h, mode, shift, seed):
    """A valid .yaik carrying ONE 2DTL pass (plane pair `mode`, tile size
    `shift`) over a dozen random, fully unclaimed tiles."""
    from yaik_tpu.encoder import corr2d
    from yaik_tpu.encoder.context import EncoderConfig, _tile2d_chunk
    from yaik_tpu.format.headers import FileHeader, MAGIC

    rng = np.random.default_rng(seed)
    sx, sy = shift
    tw, th = 1 << sx, 1 << sy
    streams = {
        "color": bytearray(), "type": [],
        3: bytearray(), 4: bytearray(), 5: bytearray(), 6: bytearray(),
        "maps": {key: np.zeros(swizzle.bitmap_size_bytes(*key, w, h) * 8,
                               np.uint8) for key in ((3, 3), (2, 2))},
    }
    txa, tya, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    slots = np.flatnonzero(valid & ((txa + 1) * tw <= w)
                           & ((tya + 1) * th <= h))
    bits = np.zeros(txa.shape[0], bool)
    for slot in sorted(rng.choice(slots, 12, replace=False)):
        bits[slot] = True
        streams["color"] += bytes(rng.integers(0, 256, 4).astype(np.uint8))
        fmt = int(rng.integers(0, 4))
        streams["type"].append(int(rng.integers(0, 40)) | (fmt << 14))
        streams[fmt + 3] += bytes(rng.integers(0, 1 << (fmt + 3), tw * th)
                                  .astype(np.uint8))
    packed = np.frombuffer(swizzle.pack_bitmap(bits), np.uint8)
    streams["maps"][shift][:len(packed)] |= packed
    body = bytearray(FileHeader(MAGIC, 1, w, h, 0).pack())
    body += _tile2d_chunk(streams, EncoderConfig(), w, h,
                          corr2d.COMPONENT[mode])
    body += struct.pack("<I", 0xDEADBEEF)
    return bytes(body)


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("shift", [(3, 3), (2, 2)])
def test_tile2d_pass_matches_host(mode, shift):
    """Each 2DTL (plane pair, size) pass alone: the device decode ==
    the host decoder on the same stream."""
    from yaik_tpu.decoder import api, planner
    from yaik_tpu.decoder import reference as refdec
    lut = api.assign_lut((FIXTURES / "LutFile.lut").read_bytes(),
                         (FIXTURES / "LutFile2D.lut").read_bytes())
    stream = _craft_t2_stream(64, 64, mode, shift, seed=7 * mode + shift[0])
    plan = planner.build_plan(stream, lut.expanded, lut.expanded2d)
    assert [(p.mode, p.shift) for p in plan.tile2d
            if p.accept.any()] == [(mode, shift)]
    want = refdec.decode(stream, lut.expanded, lut.expanded2d)
    shifts, tab, args = je.plan_to_device_args(plan, lut.expanded,
                                               lut.expanded2d)
    got = np.asarray(je.decode_pixels(shifts, tab, *args, aspec=None))
    assert np.array_equal(got[:64, :64], want)
    assert not np.array_equal(want, np.full_like(want, 0x80))
