"""Merged-T3 priority layers (t3_merge_plan) on crafted streams whose
tiles overlap on 2 and on 3+ passes - including the >2-layer fallback to
the 6 size passes and the mixed merged/legacy batch layout, none of which
any natural art stream reaches - plus the bench chain's salt hook.

Reference semantics under test: YAIK_3DTile.cpp:965-1320 (per-pixel
out = min + ((diff*LUT[idx])>>7)).
"""
import struct

import numpy as np
import pytest

import jax.numpy as jnp

from yaik_tpu.format import swizzle


# ---------------------------------------------------------------------------
# Crafted overlapping-T3 streams: priority layers, fallback, mixed batching
# ---------------------------------------------------------------------------

def _craft_t3_stream(w, h, overlap3: bool):
    """A valid .yaik whose 3DTL tiles OVERLAP at the 4x4-block level:
    16x8 at (0,0), 8x16 at (0,0) [2 layers], and with overlap3 also
    8x8 at (0,0) [3 layers -> t3_merge_plan must return None]. Later
    passes' claimed quads consume no index bytes, exactly like the
    reference decoder's tile4x4Mask skip (YAIK_3DTile.cpp:1116-1291)."""
    from yaik_tpu.encoder.context import EncoderConfig, _tile3d_chunk
    from yaik_tpu.format.headers import FileHeader, MAGIC

    rng = np.random.default_rng(42 + overlap3)
    streams = {
        "color": bytearray(), "type": [],
        3: bytearray(), 4: bytearray(), 5: bytearray(), 6: bytearray(),
        "maps": {key: np.zeros(swizzle.bitmap_size_bytes(*key, w, h) * 8,
                               np.uint8)
                 for key in swizzle.TILE3D_PASS_ORDER},
    }

    def add_tile(sx, sy, tx, ty, n_unclaimed_px):
        key = (sx, sy)
        txa, tya, valid = swizzle.tile_scan_coords(sx, sy, w, h)
        bits = np.zeros(txa.shape[0], bool)
        slot = np.flatnonzero(valid & (txa == tx) & (tya == ty))
        assert slot.size == 1
        bits[slot[0]] = True
        packed = np.frombuffer(swizzle.pack_bitmap(bits), np.uint8)
        streams["maps"][key][:len(packed)] |= packed
        mn = rng.integers(0, 100, 3)
        mx = mn + rng.integers(50, 120, 3)
        streams["color"] += bytes(np.concatenate([mn, mx]).astype(np.uint8))
        streams["type"].append(0 | (0 << 6) | (1 << 14))    # lut 0, 4-bit
        streams[4] += bytes(rng.integers(0, 16, n_unclaimed_px)
                            .astype(np.uint8))

    add_tile(4, 3, 0, 0, 128)     # 16x8: fully unclaimed
    add_tile(3, 4, 0, 0, 64)      # 8x16: top 8x8 claimed -> 4 free quads
    if overlap3:
        add_tile(3, 3, 0, 0, 0)   # 8x8: fully claimed -> 0 bytes, layer 3
    # one non-overlapping tile away from the corner keeps the 8x8 pass
    # non-degenerate in both variants
    add_tile(3, 3, 3, 3, 64)

    body = bytearray()
    body += FileHeader(MAGIC, 1, w, h, 0).pack()
    body += _tile3d_chunk(streams, EncoderConfig(), w, h)
    body += struct.pack("<I", 0xDEADBEEF)
    return bytes(body)


@pytest.fixture(scope="module")
def expanded_lut():
    import pathlib

    from yaik_tpu.format import lut as lutmod
    fix = pathlib.Path(__file__).parent / "fixtures"
    return lutmod.expand_lut(
        lutmod.parse_lut_file((fix / "LutFile.lut").read_bytes()))


def _jax_decode_plan(plan, expanded, layout=None):
    from yaik_tpu.decoder import jax_engine as je
    shifts, tab, args = je.plan_to_device_args(plan, expanded,
                                               layout=layout)
    out = np.asarray(je.decode_pixels(shifts, tab, *args,
                                      aspec=je.alpha_spec_of(plan)))
    return out[: plan.height, : plan.width]


def test_t3_overlap3_merge_returns_none_and_decodes(expanded_lut):
    """3 passes overlapping one 4x4 block: the 2-layer merge must refuse
    and the automatic legacy fallback must still decode bit-exactly vs
    the host reference engine."""
    from yaik_tpu.decoder import jax_engine as je
    from yaik_tpu.decoder import planner as plannermod
    from yaik_tpu.decoder import reference as refdec
    stream = _craft_t3_stream(64, 64, overlap3=True)
    plan = plannermod.build_plan(stream, expanded_lut)
    assert je.t3_merge_plan(plan, expanded_lut) is None
    assert je.t3_pack_mode(plan, expanded_lut) == "legacy"
    want = refdec.decode(stream, expanded_lut)
    got = _jax_decode_plan(plan, expanded_lut)
    assert np.array_equal(got, want)


def test_t3_overlap2_merged_decode_matches(expanded_lut):
    """2 passes overlapping one block: merges onto 2 priority layers and
    the merged decode == host reference == forced-legacy decode."""
    from yaik_tpu.decoder import jax_engine as je
    from yaik_tpu.decoder import planner as plannermod
    from yaik_tpu.decoder import reference as refdec
    stream = _craft_t3_stream(64, 64, overlap3=False)
    plan = plannermod.build_plan(stream, expanded_lut)
    layers = je.t3_merge_plan(plan, expanded_lut)
    assert layers is not None
    # the overlapping block really does occupy both layers
    assert bool(layers[1][0].any())
    layout = je.batch_layout([plan], expanded_lut)
    assert layout[0] == "merged"
    want = refdec.decode(stream, expanded_lut)
    got_merged = _jax_decode_plan(plan, expanded_lut, layout=layout)
    got_legacy = _jax_decode_plan(plan, expanded_lut,
                                  layout=("legacy",) + layout[1:])
    assert np.array_equal(got_merged, want)
    assert np.array_equal(got_legacy, want)


def test_combine_t3_modes_mixed_batch(expanded_lut):
    """A batch mixing a merge-capable and a >2-layer plan must combine to
    one legacy layout, and every member must decode bit-exactly under
    it."""
    from yaik_tpu.decoder import jax_engine as je
    from yaik_tpu.decoder import planner as plannermod
    from yaik_tpu.decoder import reference as refdec
    s2 = _craft_t3_stream(64, 64, overlap3=False)
    s3 = _craft_t3_stream(64, 64, overlap3=True)
    plans = [plannermod.build_plan(s, expanded_lut) for s in (s2, s3)]
    modes = [je.t3_pack_mode(p, expanded_lut) for p in plans]
    assert modes == ["merged", "legacy"]
    combined = je.batch_layout(plans, expanded_lut)
    assert combined[0] == "legacy"
    assert je.batch_layout(plans[:1], expanded_lut)[0] == "merged"
    for stream, plan in zip((s2, s3), plans):
        want = refdec.decode(stream, expanded_lut)
        got = _jax_decode_plan(plan, expanded_lut, layout=combined)
        assert np.array_equal(got, want), "mixed-mode member mismatch"
    # a merged layout cannot be forced on a plan that needs 3 layers
    with pytest.raises(ValueError):
        je.plan_to_device_args(plans[1], expanded_lut,
                               layout=("merged",) + combined[1:])


def test_salt_d1_color0_model():
    """The bench salt hook == adding s to each channel's color0 byte mod
    256, leaving base/delta2 lanes untouched (the checksum model's
    assumption)."""
    from yaik_tpu.decoder import jax_engine as je
    rng = np.random.default_rng(37)
    G = 64
    c0 = rng.integers(0, 256, (3, G)).astype(np.uint32)
    base = rng.integers(0, 256, (3, G)).astype(np.uint32)
    d2 = rng.integers(0, 1 << 21, (3, G)).astype(np.uint32)
    prm = np.stack([c0[0] | (c0[1] << 8) | (c0[2] << 16),
                    base[0] | (base[1] << 8) | (base[2] << 16),
                    d2[0], d2[1], d2[2]]).view(np.int32)
    for s in (0, 1, 7, 200, 255):
        got = np.asarray(je.salt_d1_color0(jnp.asarray(prm),
                                           jnp.int32(s)))
        cs = (c0 + s) & 0xFF
        want0 = cs[0] | (cs[1] << 8) | (cs[2] << 16)
        assert np.array_equal(got[0].view(np.uint32) if got.dtype
                              != np.uint32 else got[0], want0)
        assert np.array_equal(got[1:], prm[1:])
