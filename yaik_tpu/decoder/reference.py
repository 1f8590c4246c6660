"""Bit-exact host (numpy) YAIK decoder.

This is the semantic reference for the device path: a direct, readable port of
the reference decoder's behavior (decoder/YAIK_API.cpp chunk loop,
YAIK_Gradient.cpp, YAIK_3DTile.cpp) validated byte-for-byte against
reference-decoded fixtures. The JAX decoder reuses this module's chunk
demux and is tested against its output.

Planes are stored de-swizzled as [H8, W8] u8 (H8/W8 = image rounded up to 8);
the reference's 8x8-tile swizzle is a storage order only - all writes are
tile-aligned rectangles, so pixel values are identical.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from yaik_tpu.decoder import alpha as alphamod
from yaik_tpu.entropy import palette, zstd_backend as zstd
from yaik_tpu.format import lut as lutmod
from yaik_tpu.format import swizzle
from yaik_tpu.utils import debug_dump
from yaik_tpu.format.headers import (END_TAG, Header1D, HeaderBase,
                                     HeaderGradientTile, HeaderTile3D,
                                     HeaderTile3DX, FileHeader, MAGIC,
                                     UniqueColorHeader)

# quad-pair decode order per 3D tile size (shift_x, shift_y) -> list of
# "columns pairs": each element is a list of quad (qx, qy) processed together
# (2 = left/right pair with interleaved rows, 1 = single quad).
_PAIR_ORDER = {
    (4, 3): [[(0, 0), (1, 0)], [(0, 1), (1, 1)], [(2, 0), (3, 0)], [(2, 1), (3, 1)]],
    (3, 4): [[(0, 0), (1, 0)], [(0, 1), (1, 1)], [(0, 2), (1, 2)], [(0, 3), (1, 3)]],
    (3, 3): [[(0, 0), (1, 0)], [(0, 1), (1, 1)]],
    (3, 2): [[(0, 0), (1, 0)]],
    (2, 3): [[(0, 0)], [(0, 1)]],
    (2, 2): [[(0, 0)]],
}


@dataclass
class DecodeState:
    width: int
    height: int
    has_alpha: bool
    planes: np.ndarray        # [3, H8, W8] u8
    alpha: np.ndarray | None  # [H, W] u8 or None
    map_rgb: np.ndarray       # [nq, 3] u8 corner colors at quarter res
    has_rgb: np.ndarray       # [3, nq] bool per-plane corner-seen mask
    claims: np.ndarray        # [3, QH, QW] bool per-plane 4x4-quad claims
    single_rgb: bool = True   # masks still shared across planes
    stride_q: int = 0         # strideRGBMap = w//4 + 1

    @classmethod
    def create(cls, w: int, h: int, has_alpha: bool):
        h8, w8 = ((h + 7) // 8) * 8, ((w + 7) // 8) * 8
        stride_q = w // 4 + 1
        nq = stride_q * (h // 4 + 1)
        qh, qw = swizzle.claim_shape(w, h)
        return cls(
            width=w, height=h, has_alpha=has_alpha,
            planes=np.full((3, h8, w8), 0x80, np.uint8),
            alpha=None,
            map_rgb=np.zeros((nq, 3), np.uint8),
            has_rgb=np.zeros((3, nq), bool),
            claims=np.zeros((3, qh, qw), bool),
            stride_q=stride_q,
        )

    def split_masks(self):
        """UpdateTileAndRGBMask (YAIK_API.cpp:530-544): duplicate shared
        masks to per-plane masks on first non-RGB-combined work."""
        if self.single_rgb:
            self.single_rgb = False
            self.has_rgb[1] = self.has_rgb[0]
            self.has_rgb[2] = self.has_rgb[0]
            self.claims[1] = self.claims[0]
            self.claims[2] = self.claims[0]


def _bilinear_tile(c00, c01, c10, c11, tw: int, th: int) -> np.ndarray:
    """Exact integer bilinear fill (YAIK_Gradient.cpp blend math):
    out[ty,tx] = ((c00*(TH-ty)+c10*ty)*(TW-tx) + (c01*(TH-ty)+c11*ty)*tx)
                 >> (log2 TH + log2 TW).  Inputs are int vectors [3]."""
    ty = np.arange(th, dtype=np.int32)[:, None, None]
    tx = np.arange(tw, dtype=np.int32)[None, :, None]
    left = c00[None, None, :] * (th - ty) + c10[None, None, :] * ty
    right = c01[None, None, :] * (th - ty) + c11[None, None, :] * ty
    shift = (th.bit_length() - 1) + (tw.bit_length() - 1)
    return ((left * (tw - tx) + right * tx) >> shift).astype(np.uint8)


def _gradient_chunk(st: DecodeState, hdr: HeaderGradientTile, body: bytes):
    """Decode one GTIL chunk (all tile sizes / plane combos)."""
    w, h = st.width, st.height
    sx, sy = hdr.shift_x, hdr.shift_y
    tw, th = 1 << sx, 1 << sy

    bitmap = zstd.decompress(body[:hdr.stream_bitmap_size],
                             swizzle.bitmap_size_bytes(sx, sy, w, h))
    rgb_cust = zstd.decompress(
        body[hdr.stream_bitmap_size:hdr.stream_bitmap_size + hdr.stream_rgb_size_zstd],
        hdr.stream_rgb_size_custom)
    rgb = palette.palette_decompress(rgb_cust, hdr.stream_rgb_size_uncompressed,
                                     hdr.color_compression)
    # security offset like the reference (YAIK_API.cpp:896-910): corrupted
    # bitmaps may claim more corners than the stream holds; over-allocate
    # so reads return zeros instead of faulting
    rgb = np.concatenate(
        [rgb, np.zeros(3 * ((w // 4 + 1) * (h // 4 + 1)), np.uint8)])

    if hdr.plane != 7:
        st.split_masks()
    planes = [p for p in range(3) if hdr.plane & (1 << p)]

    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    bits = swizzle.unpack_bitmap(bitmap, sx, sy, w, h)
    sel = np.flatnonzero(bits & valid)

    cursor = 0
    sq = st.stride_q
    for i in sel:
        tx, ty = int(tx_all[i]), int(ty_all[i])
        qx, qy = tx * (tw // 4), ty * (th // 4)
        base = qy * sq + qx
        ids = (base, base + tw // 4,
               base + (th // 4) * sq, base + (th // 4) * sq + tw // 4)
        # corner consumption order: LT, RT, LB, RB
        if hdr.plane == 7:
            # the plane-7 decoders always use the plane-0 masks
            # (YAIK_Gradient.cpp: hasRGB = pInstance->mapRGBMask)
            for cid in ids:
                if not st.has_rgb[0][cid]:
                    st.has_rgb[0][cid] = True
                    st.map_rgb[cid] = rgb[cursor:cursor + 3]
                    cursor += 3
        else:
            for cid in ids:
                for p in planes:
                    if not st.has_rgb[p][cid]:
                        st.has_rgb[p][cid] = True
                        st.map_rgb[cid, p] = rgb[cursor]
                        cursor += 1
        c = st.map_rgb[list(ids)].astype(np.int32)  # [4, 3] LT RT LB RB
        tile = _bilinear_tile(c[0], c[1], c[2], c[3], tw, th)
        x, y = tx * tw, ty * th
        if hdr.plane == 7:
            st.planes[:, y:y + th, x:x + tw] = tile.transpose(2, 0, 1)
            st.claims[0][qy:qy + th // 4, qx:qx + tw // 4] = True
        else:
            for p in planes:
                st.planes[p, y:y + th, x:x + tw] = tile[:, :, p]
                st.claims[p][qy:qy + th // 4, qx:qx + tw // 4] = True


def _tile3d_size_pass(st: DecodeState, sx: int, sy: int, bitmap: bytes,
                      cursors: dict, colors: np.ndarray, types: np.ndarray,
                      idx_streams: dict, luts: dict):
    w, h = st.width, st.height
    tw, th = 1 << sx, 1 << sy
    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    # 3D tile maps are allocated bits-as-bytes (8x padded) by the encoder
    # (BitmapSwizzleMapSize, EncoderContext.cpp:7310-7314 - no /8); only the
    # leading true-bitmap bytes carry data.
    bits = swizzle.unpack_bitmap(
        bitmap[:swizzle.bitmap_size_bytes(sx, sy, w, h)], sx, sy, w, h)
    sel = np.flatnonzero(bits & valid)
    pairs = _PAIR_ORDER[(sx, sy)]
    claims = st.claims[0]  # 3D pass operates on the combined RGB claim map

    for i in sel:
        tx, ty = int(tx_all[i]), int(ty_all[i])
        x, y = tx * tw, ty * th
        rgb = colors[cursors["color"]:cursors["color"] + 6].astype(np.int32)
        cursors["color"] += 6
        tile_type = int(types[cursors["type"]])
        cursors["type"] += 1
        combined = tile_type & 0x3FFF
        fmt = (tile_type >> 14) & 3      # 0..3 -> 3..6 bit
        bit = fmt + 3
        lut = luts[bit]                  # [tables*64, 2**bit * 3] flat i32
        # guard like the reference's over-allocated LUT space
        # (YAIK_API.cpp:252-256): out-of-range table/entry reads are garbage
        # there, clamped here - corrupt streams yield garbage pixels, not OOB
        combined = min(combined, lut.shape[0] - 1)
        diff = rgb[3:6] - rgb[0:3]

        stream = idx_streams[bit]
        cur = cursors[bit]
        qx0, qy0 = x // 4, y // 4

        for group in pairs:
            if len(group) == 2:
                (gx0, gy0), (gx1, _) = group
                b0 = claims[qy0 + gy0, qx0 + gx0]
                b1 = claims[qy0 + gy0, qx0 + gx1]
                px, py = x + gx0 * 4, y + gy0 * 4
                if not b0 and not b1:
                    idxs = np.minimum(stream[cur:cur + 32].astype(np.int64), lut.shape[1] - 3); cur += 32
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px:px + 8] = (
                        out.reshape(4, 8, 3).transpose(2, 0, 1))
                elif not b0:
                    idxs = np.minimum(stream[cur:cur + 16].astype(np.int64), lut.shape[1] - 3); cur += 16
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px:px + 4] = (
                        out.reshape(4, 4, 3).transpose(2, 0, 1))
                elif not b1:
                    idxs = np.minimum(stream[cur:cur + 16].astype(np.int64), lut.shape[1] - 3); cur += 16
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px + 4:px + 8] = (
                        out.reshape(4, 4, 3).transpose(2, 0, 1))
            else:
                (gx0, gy0), = group
                px, py = x + gx0 * 4, y + gy0 * 4
                if not claims[qy0 + gy0, qx0 + gx0]:
                    idxs = np.minimum(stream[cur:cur + 16].astype(np.int64), lut.shape[1] - 3); cur += 16
                    vals = lut[combined, idxs[:, None] + np.arange(3)]
                    out = ((rgb[None, 0:3] + ((diff[None, :] * vals) >> 7))
                           & 0xFF).astype(np.uint8)
                    st.planes[:, py:py + 4, px:px + 4] = (
                        out.reshape(4, 4, 3).transpose(2, 0, 1))
        cursors[bit] = cur
        # claim the full tile rect (all variants end up claiming their area)
        claims[qy0:qy0 + th // 4, qx0:qx0 + tw // 4] = True


def _tile3d_chunk(st: DecodeState, hdr: HeaderTile3D, body: bytes,
                  luts_expanded: dict):
    off = 0

    def take(csize: int, usize: int):
        nonlocal off
        d = zstd.decompress(body[off:off + csize], usize) if csize else b""
        off += csize
        return d

    s3 = take(hdr.compr_3bit_size, hdr.stream_3bit_cnt)
    s4 = take(hdr.compr_4bit_size, hdr.stream_4bit_cnt)
    s5 = take(hdr.compr_5bit_size, hdr.stream_5bit_cnt)
    s6 = take(hdr.compr_6bit_size, hdr.stream_6bit_cnt)
    types_b = take(hdr.compr_type_size, hdr.stream_type_cnt * 2)
    colors_b = take(hdr.compr_color_size, hdr.stream_color_cnt)
    m16_8 = take(hdr.size_t16_8_map_cmp, hdr.size_t16_8_map)
    m8_16 = take(hdr.size_t8_16_map_cmp, hdr.size_t8_16_map)
    m8_8 = take(hdr.size_t8_8_map_cmp, hdr.size_t8_8_map)
    m8_4 = take(hdr.size_t8_4_map_cmp, hdr.size_t8_4_map)
    m4_8 = take(hdr.size_t4_8_map_cmp, hdr.size_t4_8_map)
    m4_4 = take(hdr.size_t4_4_map_cmp, hdr.size_t4_4_map)

    colors = palette.full_range_remap(np.frombuffer(colors_b, np.uint8),
                                      hdr.compression_rate_color)
    types = np.frombuffer(types_b, "<u2")
    idx_streams = {3: np.frombuffer(s3, np.uint8),
                   4: np.frombuffer(s4, np.uint8),
                   5: np.frombuffer(s5, np.uint8),
                   6: np.frombuffer(s6, np.uint8)}
    # flatten LUTs: [tables*64, 2**bit * 3] so premultiplied-by-3 stream
    # indices address them directly (encoder premultiply EncoderContext.cpp:
    # 7520-7531, decoder use YAIK_3DTile.cpp:1071-1076)
    luts = {bit: arr.reshape(arr.shape[0], -1)
            for bit, arr in luts_expanded.items()}

    # popcount cross-validation (CheckTileCount, YAIK_API.cpp:628-641):
    # cumulative accepted-tile count must stay within the type stream
    cursors = {"color": 0, "type": 0, 3: 0, 4: 0, 5: 0, 6: 0}
    maps = {(4, 3): m16_8, (3, 4): m8_16, (3, 3): m8_8,
            (3, 2): m8_4, (2, 3): m4_8, (2, 2): m4_4}
    # over-allocate streams so within-tile overruns on corrupt claims read
    # zeros (the reference's security-offset model)
    total_px = st.planes.shape[1] * st.planes.shape[2]
    colors = np.concatenate([colors, np.zeros(total_px * 6, np.uint8)])
    idx_streams = {b: np.concatenate([s, np.zeros(total_px, np.uint8)])
                   for b, s in idx_streams.items()}
    security_count = 0
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        if maps[(sx, sy)]:
            bm = swizzle.unpack_bitmap(
                maps[(sx, sy)][:swizzle.bitmap_size_bytes(
                    sx, sy, st.width, st.height)], sx, sy, st.width, st.height)
            security_count += int(bm.sum())
            if security_count > hdr.stream_type_cnt:
                continue
            _tile3d_size_pass(st, sx, sy, maps[(sx, sy)], cursors,
                              colors, types, idx_streams, luts)


def decode_smap_seeds(hdr, body: bytes, w: int, h: int):
    """Reconstruct the SMAP seed list: replay the encoder's 1/16-res
    enumeration (encoder/smooth_map.py) over the 1-bit half-res map,
    including the clamped reads and the in-buffer 128-marker evolution.
    Returns [n, 5] i32 (x, y, Y, Co, Cg)."""
    qh, qw = h // 2, w // 2
    n_bits = hdr.w * hdr.h
    raw = zstd.decompress_arr(body[:hdr.stream_size], (n_bits + 7) >> 3) \
        if hdr.stream_size else np.zeros(0, np.uint8)
    rgb = zstd.decompress_arr(
        body[hdr.stream_size:hdr.stream_size + hdr.rgb_stream_size],
        hdr.expected_rgb_stream_size) if hdr.rgb_stream_size else \
        np.zeros(0, np.uint8)

    q = np.zeros(qh * qw, np.int32)
    if n_bits:
        bits = np.unpackbits(raw, bitorder="little")[:n_bits]
        ys, xs = np.mgrid[hdr.y:hdr.y + hdr.h, hdr.x:hdr.x + hdr.w]
        idx = (xs + ys * qw).reshape(-1)
        ok = idx < q.size
        q[idx[ok]] = bits[ok] * 255

    q2 = q.reshape(qh, qw)
    seeds = []
    cur = 0
    for y in range(0, h, 4):
        for x in range(0, w, 4):
            cx, cy = min(x, qw - 1), min(y, qh - 1)
            if q2[cy, cx]:
                if x + y * qw < qw * qh:
                    q[x + y * qw] = 128
                if cur + 3 <= rgb.size:
                    seeds.append((x, y, int(rgb[cur]), int(rgb[cur + 1]),
                                  int(rgb[cur + 2])))
                cur += 3
    return np.asarray(seeds, np.int32).reshape(-1, 5)


def _smap_chunk(st: DecodeState, body: bytes):
    """Apply a SMAP chunk (tag deprecated by the reference decoder,
    YAIK_API.cpp:569): paint the YCoCg seed points, converted to RGB, at
    their full-res positions. No claims (the pass never touched
    mapSmoothTile)."""
    from yaik_tpu.format.headers import HeaderSmoothMap
    from yaik_tpu.ops import plane as ops
    hdr = HeaderSmoothMap.unpack(body)
    seeds = decode_smap_seeds(hdr, body[HeaderSmoothMap.size():],
                              st.width, st.height)
    if not len(seeds):
        return
    # Co/Cg are signed halves stored as wrapped bytes (&0xFF at encode)
    co = ((seeds[:, 3].astype(np.int64) + 128) % 256) - 128
    cg = ((seeds[:, 4].astype(np.int64) + 128) % 256) - 128
    r, g, b = ops.ycocg_to_rgb(seeds[:, 2].astype(np.int64), co, cg)
    st.planes[0][seeds[:, 1], seeds[:, 0]] = r & 0xFF
    st.planes[1][seeds[:, 1], seeds[:, 0]] = g & 0xFF
    st.planes[2][seeds[:, 1], seeds[:, 0]] = b & 0xFF


def decode_plnt_plane(hdr, body: bytes, valid: np.ndarray | None = None):
    """Reconstruct one PLNT plane (the disabled DynamicTileEncode chunk,
    encoder/plnt.py). Returns (plane i32 [h, w] with -999 at never-written
    pixels, n_tiles).

    The stream does NOT record per-tile signedness: Co/Cg tiles whose
    minimum was negative were shifted +128 at encode and nothing marks
    them (the reference never wrote a PLNT decoder; its encoder preview
    guesses at EncoderContext.cpp:4444). Values returned are the raw
    0..255 LUT outputs; callers owning the sign convention shift them."""
    from yaik_tpu.encoder.plnt import curves_from, min_range_decode, \
        diff_range_decode
    h, w = hdr.h, hdr.w   # bbox in plane space; planes start at (x, y)
    # the tile count is not in the header; the zstd frame records it
    usize = zstd.frame_content_size(body[:hdr.stream_size_tile_map])
    if usize is None or usize > (hdr.w // 8) * (hdr.h // 8) * 2:
        raise ValueError("PLNT tile map size missing or out of bounds")
    types = np.frombuffer(
        zstd.decompress(body[:hdr.stream_size_tile_map], usize), "<u2")
    codes_packed = zstd.decompress(
        body[hdr.stream_size_tile_map:
             hdr.stream_size_tile_map + hdr.stream_size_tile_stream],
        hdr.expected_size_tile_stream)
    nib = np.frombuffer(codes_packed, np.uint8)
    codes = np.empty(nib.size * 2, np.uint8)
    codes[0::2] = nib & 0xF
    codes[1::2] = nib >> 4

    if valid is None:
        valid = np.ones((hdr.y + h, hdr.x + w), bool)
    plane = np.full((hdr.y + h, hdr.x + w), -999, np.int32)
    ti = 0
    ci = 0
    for ty in range(hdr.y, hdr.y + h, 8):
        for tx in range(hdr.x, hdr.x + w, 8):
            sel = valid[ty:ty + 8, tx:tx + 8]
            n_valid = int(sel.sum())
            if n_valid == 0:
                continue
            if ti >= len(types):
                raise ValueError("PLNT tile map shorter than claimed tiles")
            t = int(types[ti])
            ti += 1
            mode = t >> 13
            rng = (t >> 7) & 0x3F
            base = t & 0x7F
            # rebuild the mode LUT straight from the decoded (BN, dist)
            bn = min_range_decode(base)
            dist = diff_range_decode(rng, bn)
            luts = curves_from(bn, dist)
            lut = np.asarray(luts[mode], np.int64)
            tile_codes = codes[ci:ci + n_valid]
            ci += n_valid
            vals = lut[np.minimum(tile_codes, len(lut) - 1)]
            block = np.full((sel.shape[0], sel.shape[1]), -999, np.int64)
            block[sel] = vals
            plane[ty:ty + 8, tx:tx + 8] = block
    return plane, ti


# 2DTL component bitmask -> (plane A, plane B)
_PAIR2D = {3: (0, 1), 6: (1, 2), 5: (0, 2)}


def _tile2d_size_pass(st: DecodeState, pa: int, pb: int, sx: int, sy: int,
                      bitmap: bytes, cursors: dict, colors: np.ndarray,
                      types: np.ndarray, idx_streams: dict, luts: dict):
    """Tile2D_{8x8,4x4}_{RG,GB,RB} (YAIK_3DTile.cpp:2145-3809): 4-byte
    min/max color pairs, x2-premultiplied indices, two planes written as
    min + (diff * LUT)>>7.

    Claim handling deviation (documented): the reference's dead Tile2D code
    reads AND writes only the R-plane claim section regardless of mode
    (:2155 pixelUsed = tile4x4Mask). The encoder's model claims BOTH pair
    planes (EncoderContext.cpp:7243-7270); we mirror the encoder so the
    following 1DTL stays cursor-synchronized on every plane (the two agree
    on the reference's own canonical pass order)."""
    w, h = st.width, st.height
    tw, th = 1 << sx, 1 << sy
    tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    bits = swizzle.unpack_bitmap(
        bitmap[:swizzle.bitmap_size_bytes(sx, sy, w, h)], sx, sy, w, h)
    sel = np.flatnonzero(bits & valid)
    pairs = _PAIR_ORDER[(sx, sy)]
    st.split_masks()
    cl_a, cl_b = st.claims[pa], st.claims[pb]

    for i in sel:
        tx, ty = int(tx_all[i]), int(ty_all[i])
        x, y = tx * tw, ty * th
        ab = colors[cursors["color"]:cursors["color"] + 4].astype(np.int32)
        cursors["color"] += 4
        tile_type = int(types[cursors["type"]])
        cursors["type"] += 1
        combined = tile_type & 0x3FFF
        fmt = (tile_type >> 14) & 3
        bit = fmt + 3
        flat, row_size, n_rows = luts[bit]   # flat i32 bit section + guard
        combined = min(combined, n_rows - 1)
        base = combined * row_size
        mn = ab[0:2]
        diff = ab[2:4] - ab[0:2]

        stream = idx_streams[bit]
        cur = cursors[bit]
        qx0, qy0 = x // 4, y // 4

        def emit(px, py, qw):
            nonlocal cur
            npx = 16 * qw                # 16 or 32 pixels
            # stream bytes are x2-premultiplied byte offsets into the flat
            # section; 3-bit tiles legitimately overrun their 16-byte block
            # into the NEXT pattern's entries (the encoder's 4-bit-map
            # idx3Bit bug, EncoderContext.cpp:5642 - the reference decoder
            # reads straight through, YAIK_3DTile.cpp:2255)
            idxs = np.minimum(base + stream[cur:cur + npx].astype(np.int64),
                              flat.size - 2)
            cur += npx
            vals = flat[idxs[:, None] + np.arange(2)]
            out = ((mn[None, :] + ((diff[None, :] * vals) >> 7))
                   & 0xFF).astype(np.uint8)
            out = out.reshape(4, qw * 4, 2)
            st.planes[pa, py:py + 4, px:px + qw * 4] = out[:, :, 0]
            st.planes[pb, py:py + 4, px:px + qw * 4] = out[:, :, 1]

        for group in pairs:
            if len(group) == 2:
                (gx0, gy0), (gx1, _) = group
                b0 = cl_a[qy0 + gy0, qx0 + gx0] | cl_b[qy0 + gy0, qx0 + gx0]
                b1 = cl_a[qy0 + gy0, qx0 + gx1] | cl_b[qy0 + gy0, qx0 + gx1]
                px, py = x + gx0 * 4, y + gy0 * 4
                if not b0 and not b1:
                    emit(px, py, 2)
                elif not b0:
                    emit(px, py, 1)
                elif not b1:
                    emit(px + 4, py, 1)
            else:
                (gx0, gy0), = group
                px, py = x + gx0 * 4, y + gy0 * 4
                if not (cl_a[qy0 + gy0, qx0 + gx0]
                        | cl_b[qy0 + gy0, qx0 + gx0]):
                    emit(px, py, 1)
        cursors[bit] = cur
        cl_a[qy0:qy0 + th // 4, qx0:qx0 + tw // 4] = True
        cl_b[qy0:qy0 + th // 4, qx0:qx0 + tw // 4] = True


def _tile2d_chunk(st: DecodeState, hdr: HeaderTile3D, body: bytes,
                  luts2d_expanded: dict):
    """2DTL: HeaderTile3D with component 3/5/6; only the 8x8 and 4x4 maps
    are populated (EndCorrelationSearch(false,...), EncoderContext.cpp:
    7382-7612)."""
    if hdr.component not in _PAIR2D:
        raise ValueError("invalid 2DTL component")  # YAIK_INVALID_PLANE_ID
    pa, pb = _PAIR2D[hdr.component]
    off = 0

    def take(csize: int, usize: int):
        nonlocal off
        d = zstd.decompress(body[off:off + csize], usize) if csize else b""
        off += csize
        return d

    s3 = take(hdr.compr_3bit_size, hdr.stream_3bit_cnt)
    s4 = take(hdr.compr_4bit_size, hdr.stream_4bit_cnt)
    s5 = take(hdr.compr_5bit_size, hdr.stream_5bit_cnt)
    s6 = take(hdr.compr_6bit_size, hdr.stream_6bit_cnt)
    types_b = take(hdr.compr_type_size, hdr.stream_type_cnt * 2)
    colors_b = take(hdr.compr_color_size, hdr.stream_color_cnt)
    m8_8 = take(hdr.size_t8_8_map_cmp, hdr.size_t8_8_map)
    m4_4 = take(hdr.size_t4_4_map_cmp, hdr.size_t4_4_map)

    colors = palette.full_range_remap(np.frombuffer(colors_b, np.uint8),
                                      hdr.compression_rate_color)
    types = np.frombuffer(types_b, "<u2")
    idx_streams = {3: np.frombuffer(s3, np.uint8),
                   4: np.frombuffer(s4, np.uint8),
                   5: np.frombuffer(s5, np.uint8),
                   6: np.frombuffer(s6, np.uint8)}
    # flat per-bit sections + guard so 3-bit block overruns read the next
    # pattern's entries like the reference (see _tile2d_size_pass.emit)
    luts = {}
    for bit, arr in luts2d_expanded.items():
        flat = np.concatenate([arr.reshape(-1).astype(np.int64),
                               np.zeros(256, np.int64)])
        luts[bit] = (flat, arr.shape[1] * 2, arr.shape[0])

    cursors = {"color": 0, "type": 0, 3: 0, 4: 0, 5: 0, 6: 0}
    total_px = st.planes.shape[1] * st.planes.shape[2]
    colors = np.concatenate([colors, np.zeros(total_px * 4, np.uint8)])
    idx_streams = {b: np.concatenate([s, np.zeros(total_px, np.uint8)])
                   for b, s in idx_streams.items()}
    security_count = 0
    for (sx, sy), m in (((3, 3), m8_8), ((2, 2), m4_4)):
        if m:
            bm = swizzle.unpack_bitmap(
                m[:swizzle.bitmap_size_bytes(sx, sy, st.width, st.height)],
                sx, sy, st.width, st.height)
            security_count += int(bm.sum())
            if security_count > hdr.stream_type_cnt:
                continue
            _tile2d_size_pass(st, pa, pb, sx, sy, m, cursors,
                              colors, types, idx_streams, luts)


def _tile1d_chunk(st: DecodeState, hdr: Header1D, body: bytes):
    types = np.frombuffer(
        zstd.decompress(body[:hdr.stream_type_cnt], hdr.stream_type_uncmp),
        np.uint8)
    pix = np.frombuffer(
        zstd.decompress(body[hdr.stream_type_cnt:
                             hdr.stream_type_cnt + hdr.stream_pixel_bit],
                        hdr.stream_pixel_uncmp), np.uint8)
    st.split_masks()
    # over-allocate so corrupt claim patterns read zeros, not OOB
    total_tiles = (st.planes.shape[1] // 8) * (st.planes.shape[2] // 8)
    types = np.concatenate([types, np.zeros(total_tiles * 9, np.uint8)])
    pix = np.concatenate([pix, np.zeros(total_tiles * 64 * 3, np.uint8)])
    if hdr.compression_range == 0:
        raise ValueError("invalid 1D compression range")
    inv_range = (1 << 24) // hdr.compression_range
    tcur = 0
    pcur = 0
    w, h = st.width, st.height
    for p in range(3):
        claims = st.claims[p]
        plane = st.planes[p]
        for y in range(0, h, 8):
            for x in range(0, w, 8):
                qx0, qy0 = x // 4, y // 4
                quad = claims[qy0:qy0 + 2, qx0:qx0 + 2]
                if quad.all():
                    continue
                color0 = int(types[tcur]); base = int(types[tcur + 1])
                delta = int(types[tcur + 2]); tcur += 3
                delta2 = ((delta * inv_range) >> 8) + 1
                for gy in range(2):
                    b0 = bool(quad[gy, 0]); b1 = bool(quad[gy, 1])
                    py = y + gy * 4
                    if not b0 and not b1:
                        ls = pix[pcur:pcur + 32].astype(np.int64); pcur += 32
                        vals = np.where(ls != 0,
                                        (base + (((ls - 1) * delta2) >> 16)),
                                        color0).astype(np.uint8)
                        plane[py:py + 4, x:x + 8] = vals.reshape(4, 8)
                    elif not b0:
                        ls = pix[pcur:pcur + 16].astype(np.int64); pcur += 16
                        vals = np.where(ls != 0,
                                        (base + (((ls - 1) * delta2) >> 16)),
                                        color0).astype(np.uint8)
                        plane[py:py + 4, x:x + 4] = vals.reshape(4, 4)
                    elif not b1:
                        ls = pix[pcur:pcur + 16].astype(np.int64); pcur += 16
                        vals = np.where(ls != 0,
                                        (base + (((ls - 1) * delta2) >> 16)),
                                        color0).astype(np.uint8)
                        plane[py:py + 4, x + 4:x + 8] = vals.reshape(4, 4)


def decode_ucol_map(hdr, body: bytes):
    """Reconstruct the UCOL palette-index map: palette [n, 3] u8 plus the
    replayed span stream as a [bh*bw] u8 map (indices in swizzle space when
    hdr.version == 2). The encoder's verifyComp (EncoderContext.cpp:1749)
    documents the replay: pos += deltaStart; copy length bytes."""
    n_colors = hdr.color_count - 1 if hdr.color_count else 255
    off = 0
    palette = np.frombuffer(body, np.uint8, n_colors * 3, off).reshape(-1, 3)
    off += n_colors * 3
    z_map = body[off:off + hdr.stream_size]
    off += hdr.stream_size
    z_spans = body[off:off + hdr.stream_size_e]
    stream = zstd.decompress_arr(z_map, hdr.expected_decompression_size)
    spans = np.frombuffer(
        zstd.decompress(z_spans, hdr.expected_decompression_skippers),
        "<u4").reshape(-1, 2)
    map_size = hdr.w * hdr.h
    map_pixel = np.zeros(map_size, np.uint8)
    pos = 0
    cur = 0
    for delta, length in spans:
        pos += int(delta)
        if pos + int(length) > map_size or cur + int(length) > stream.size:
            raise ValueError("UCOL span exceeds map bounds")
        map_pixel[pos:pos + length] = stream[cur:cur + length]
        cur += int(length)
    return palette, map_pixel


def _ucol_chunk(st: DecodeState, body: bytes):
    """Apply a UCOL chunk (the reference decoder deprecates the tag at
    YAIK_API.cpp:568; semantics follow the encoder pass, which maps palette
    slot v>0 at swizzled bbox index n to an exact RGB)."""
    hdr = UniqueColorHeader.unpack(body)
    # corrupt headers must fail as ValueError, not an internal IndexError:
    # the bbox and (for the swizzled layout) its 8-alignment bound every
    # write below
    if (hdr.x < 0 or hdr.y < 0 or hdr.w <= 0 or hdr.h <= 0
            or hdr.x + hdr.w > st.width or hdr.y + hdr.h > st.height):
        raise ValueError("UCOL bbox out of image bounds")
    if hdr.version == 2 and (hdr.w % 8 or hdr.h % 8):
        raise ValueError("UCOL swizzled bbox not 8-aligned")
    palette, map_pixel = decode_ucol_map(hdr, body[UniqueColorHeader.size():])
    n = np.flatnonzero(map_pixel)
    if not n.size:
        return
    v = map_pixel[n]
    if int(v.max()) > palette.shape[0]:
        raise ValueError("UCOL palette index out of range")
    if hdr.version == 2:   # swizzled: n = xL | yL<<3 | (xU + yU*(bw>>3))<<6
        tile = n >> 6
        wu = hdr.w >> 3
        x = ((tile % wu) << 3) | (n & 7)
        y = ((tile // wu) << 3) | ((n >> 3) & 7)
    else:
        x, y = n % hdr.w, n // hdr.w
    cols = palette[v - 1]  # file stores colors 1..n; slot 0 never mapped
    st.planes[0][hdr.y + y, hdr.x + x] = cols[:, 0]
    st.planes[1][hdr.y + y, hdr.x + x] = cols[:, 1]
    st.planes[2][hdr.y + y, hdr.x + x] = cols[:, 2]


def iter_chunks(stream: bytes):
    """Yield (tag, header_offset, body) for each chunk; validates bounds."""
    off = FileHeader.size()
    n = len(stream)
    while True:
        if off + 4 > n:
            raise ValueError("stream ended without 0xDEADBEEF")
        tag32 = int.from_bytes(stream[off:off + 4], "little")
        if tag32 == END_TAG:
            return
        hb = HeaderBase.unpack(stream, off)
        body_start = off + HeaderBase.size()
        body_end = body_start + hb.length
        if body_end > n:
            raise ValueError("chunk exceeds stream bounds")
        yield hb.tag, body_start, stream[body_start:body_end]
        off = body_end


def decode(stream: bytes, lut_data: bytes | dict,
           lut2d_data: bytes | dict | None = None) -> np.ndarray:
    """Decode a .yaik stream. Returns [h, w, 3] u8 (RGBA when alpha present).
    lut_data: raw LutFile.lut bytes or an already-expanded LUT dict.
    lut2d_data: LutFile2D.lut bytes / expanded dict, required only for
    streams carrying 2DTL chunks."""
    if len(stream) <= FileHeader.size():
        raise ValueError("stream too small")  # YAIK_INVALID_STREAM
    fh = FileHeader.unpack(stream)
    if fh.tag != MAGIC:
        raise ValueError("not a YAIK stream")
    st = DecodeState.create(fh.width, fh.height, fh.has_alpha)
    if debug_dump.enabled():
        debug_dump.begin_decode()      # fresh numbering per invocation
    if isinstance(lut_data, dict):
        luts_expanded = lut_data
    else:
        luts_expanded = lutmod.expand_lut(lutmod.parse_lut_file(lut_data))

    import struct as _struct
    mip_mask = None
    mip_bbox = None
    def _chunks_checked(s):
        try:
            yield from iter_chunks(s)
        except _struct.error as e:
            raise ValueError(f"malformed chunk: {e}") from e
    for tag, off, body in _chunks_checked(stream):
        try:
            if tag == b"GTIL":
                hdr = HeaderGradientTile.unpack(body)
                _gradient_chunk(st, hdr, body[HeaderGradientTile.size():])
            elif tag in (b"3DTL", b"3DTX"):
                cls = HeaderTile3D if tag == b"3DTL" else HeaderTile3DX
                hdr = cls.unpack(body)
                _tile3d_chunk(st, hdr, body[cls.size():], luts_expanded)
            elif tag == b"2DTL":
                if lut2d_data is None:
                    raise ValueError("2DTL chunk but no 2D LUT assigned")
                if isinstance(lut2d_data, dict):
                    luts2d = lut2d_data
                else:
                    luts2d = lutmod.expand_lut2d(
                        lutmod.parse_lut2d_file(lut2d_data))
                    lut2d_data = luts2d
                hdr = HeaderTile3D.unpack(body)
                _tile2d_chunk(st, hdr, body[HeaderTile3D.size():], luts2d)
            elif tag == b"1DTL":
                hdr = Header1D.unpack(body)
                _tile1d_chunk(st, hdr, body[Header1D.size():])
            elif tag == b"MIPM":
                mip_mask, mip_bbox = alphamod.decode_mipm(body, fh.width,
                                                          fh.height)
            elif tag == b"ALPM":
                st.alpha = alphamod.decode_alpm(body, fh.width, fh.height,
                                                mip_mask, mip_bbox)
            elif tag == b"UCOL":
                _ucol_chunk(st, body)
            elif tag == b"SMAP":
                _smap_chunk(st, body)
            elif tag == b"PLNT":
                # structure-validated but not applied: the chunk carries
                # YCoCg planes for a pipeline the reference never finished
                # (tag deprecated at YAIK_API.cpp:567, no decoder exists,
                # and per-tile signedness is unrecorded). Standalone
                # reconstruction: decode_plnt_plane.
                from yaik_tpu.format.headers import PlaneTile
                ph = PlaneTile.unpack(body)
                pb = body[PlaneTile.size():]
                usize = zstd.frame_content_size(
                    pb[:ph.stream_size_tile_map])
                if usize is None or usize > (ph.w // 8) * (ph.h // 8) * 2:
                    raise ValueError("PLNT tile map size out of bounds")
                zstd.decompress(pb[:ph.stream_size_tile_map], usize)
                zstd.decompress(
                    pb[ph.stream_size_tile_map:
                       ph.stream_size_tile_map + ph.stream_size_tile_stream],
                    ph.expected_size_tile_stream)
            else:
                raise ValueError(f"unknown chunk tag {tag!r}")
        except _struct.error as e:
            raise ValueError(f"malformed {tag!r} chunk: {e}") from e
        if debug_dump.enabled():           # YAIK_DEVEL Debug_RGBandTILE
            debug_dump.snapshot_decode(tag, st)

    out = st.planes[:, :fh.height, :fh.width].transpose(1, 2, 0)
    if st.has_alpha:
        if st.alpha is None:
            # hasAlpha stream without an ALPM chunk (all-0/all-1 alpha is
            # dropped by the encoder); default opaque
            st.alpha = np.full((fh.height, fh.width), 255, np.uint8)
        out = np.concatenate([out, st.alpha[:, :, None]], axis=2)
    return np.ascontiguousarray(out)
