"""Device-scored encode pipeline.

The O(pixels) work - gradient variant scoring and the 3D-LUT tile search
(every tile x every LUT x 48 patterns) - runs on the accelerator
(encoder.jax_scoring); the host keeps the O(tiles) sequential parts
(scan-order corner dedup, stream cursors, palette + zstd entropy, chunk
mux). The device's float32 normalizations are exact twins of the host's
(jax_scoring._norm_coords); everything else device-side is integer.
Produces byte-identical streams to the host pipeline (tested)."""
from __future__ import annotations

import os

import numpy as np

import jax
import jax.numpy as jnp

from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder import jax_scoring
from yaik_tpu.format import swizzle


def bank_device_tables(bank: bankmod.Bank):
    """Pack the bank into device arrays: (qpts [E,48,8,3], pts [E,64,3],
    factors [4,E,64,3] for bits 3,4,5,6 at indices 0..3)."""
    E = bank.count
    pts = np.zeros((E, 64, 3), np.int32)
    for e, p in enumerate(bank.points):
        pts[e, :len(p)] = p
    qpts = jax_scoring.transformed_points(pts[:, ::8][:, :8])
    factors = np.zeros((4, E, 64, 3), np.int32)
    for e, ctx in enumerate(bank.ctxs):
        for bi, bit in enumerate((3, 4, 5, 6)):
            t = ctx.factors[bit]
            factors[bi, e, :t.shape[0]] = t
    return (jnp.asarray(qpts), jnp.asarray(pts), jnp.asarray(factors))


def run_gradient_scoring(planes_dev, claims_dev, reject_factor):
    """All 7 gradient passes in one device dispatch; returns
    (accept grids as numpy, final claims)."""
    accepts, claims_dev = jax_scoring.gradient_all_device(
        planes_dev, claims_dev, reject_factor)
    return [np.asarray(a) for a in accepts], claims_dev


import jax.numpy as _jnp
from functools import partial as _partial


@_partial(jax.jit, static_argnames=("sx", "sy", "cap_score"))
def _resident_packed(planes_b, claims_b, qpts, pts, factors, sx, sy,
                     cap_score=None):
    """One resident 3D pass over a batch [B,3,H,W]; outputs packed into a
    single u8 array [B, T, P+9] = (idx | mask<<6)(P) | acc(1) | typ(2) |
    bbox(6) - one device->host transfer per pass, ~1 byte/pixel (idx is 6
    bits, mask 1).
    cap_score (static): alive-tile scoring compaction (jax_scoring doc);
    alive_cnt [B] lets the host detect cap overflow."""
    accept, typ, idx, mask, mn, mx, claims_b, alive_cnt = \
        jax_scoring.tile3d_pass_resident_b.__wrapped__(
            planes_b, claims_b, qpts, pts, factors, sx, sy,
            cap_score=cap_score)
    packed = _jnp.concatenate([
        (idx | (mask.astype(_jnp.int32) << 6)).astype(_jnp.uint8),
        accept.astype(_jnp.uint8)[:, :, None],
        (typ & 0xFF).astype(_jnp.uint8)[:, :, None],
        ((typ >> 8) & 0xFF).astype(_jnp.uint8)[:, :, None],
        mn.astype(_jnp.uint8), mx.astype(_jnp.uint8)], axis=2)
    return packed, claims_b, alive_cnt


def _unpack_pass(packed, P):
    im = packed[:, :P]
    idx = (im & 63).astype(np.int32)
    mask = (im >> 6).astype(bool)
    accept = packed[:, P].astype(bool)
    typ = (packed[:, P + 1].astype(np.int32)
           | (packed[:, P + 2].astype(np.int32) << 8))
    bbox = packed[:, P + 3:P + 9].astype(np.int32)
    return idx, mask, accept, typ, bbox


@jax.jit
def _tile3d_all(planes_b, claims_b, qpts, pts, factors):
    """All six 3D size passes in ONE dispatch over a batch [B,3,H,W]
    (claims evolve in-graph); outputs one packed u8 vector per (image,
    pass), concatenated pass-major to match the host unpack order."""
    B = planes_b.shape[0]
    outs = []
    for (sx, sy) in [(4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2)]:
        packed, claims_b, _ = _resident_packed.__wrapped__(
            planes_b, claims_b, qpts, pts, factors, sx, sy)
        outs.append(packed.reshape(B, -1))
    return jnp.concatenate(outs, axis=1), claims_b


def run_tile3d_scoring(planes_dev, claims_dev, tables):
    """All 6 3D passes fully device-resident in a single dispatch
    (planes/claims never leave the device; normalizations are exact
    on-device - see tile3d_pass_resident). Returns
    (list of per-pass dicts as numpy, final claims device array)."""
    qpts, pts, factors = tables
    _, h, w = planes_dev.shape
    packed_all, claims_b = _tile3d_all(planes_dev[None], claims_dev[None],
                                       qpts, pts, factors)
    claims_dev = claims_b[0]
    packed_all = np.asarray(packed_all)[0]
    results, off = [], 0
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        tw, th = 1 << sx, 1 << sy
        P = tw * th
        T = (h // th) * (w // tw)
        n = T * (P + 9)
        packed = packed_all[off:off + n].reshape(T, P + 9)
        off += n
        idx, mask, accept, typ, bbox = _unpack_pass(packed, P)
        results.append({"shift": (sx, sy), "accept": accept, "type": typ,
                        "bbox": bbox, "idx": idx, "mask": mask})
    return results, claims_dev


def emit_tile3d_streams(results, w, h, streams):
    """Host emission from device 3D scoring outputs: scan-order stream
    append identical to corr3d.run_pass."""
    for res in results:
        sx, sy = res["shift"]
        tw, th = 1 << sx, 1 << sy
        ntx = w // tw
        accept = res["accept"]
        types = res["type"]
        bbox = res["bbox"]
        idx = res["idx"]
        mask = res["mask"]

        tx_all, ty_all, valid = swizzle.tile_scan_coords(sx, sy, w, h)
        inside = ((tx_all + 1) * tw <= w) & ((ty_all + 1) * th <= h)
        bits = np.zeros(tx_all.shape[0], bool)
        # slot order within a tile: xa 8-col blocks, then rows, then cols
        # (computeValues3D iteration, EncoderContext.cpp:5854-5860)
        if tw > 8:
            order = []
            for xa in range(2):
                for y in range(th):
                    for x in range(8):
                        order.append(y * tw + xa * 8 + x)
            order = np.asarray(order)
        else:
            order = np.arange(th * tw)

        # vectorized scan-order emission (bit-identical to the old per-tile
        # loop): accepted tiles in scan order, colors/types appended per
        # tile, per-bit index streams built from the slot-reordered
        # (idx, mask) rows - the row-major ravel of [tile, slot] preserves
        # both the tile order and the within-tile slot order
        sel = np.flatnonzero(valid & inside)
        gids = ty_all[sel].astype(np.int64) * ntx + tx_all[sel]
        acc = accept[gids].astype(bool)
        sel = sel[acc]
        gids = gids[acc]
        if gids.size:
            bits[sel] = True
            streams["color"] += bbox[gids].astype(np.uint8).tobytes()
            tvals = types[gids].astype(np.int64)
            streams["type"].extend(tvals.tolist())
            idxo = idx[gids][:, order]
            masko = mask[gids][:, order].astype(bool)
            bit_arr = ((tvals >> 14) & 3) + 3
            for bit in (3, 4, 5, 6):
                tb = bit_arr == bit
                if tb.any():
                    rows = idxo[tb]
                    streams[bit] += rows[~masko[tb]].astype(
                        np.uint8).tobytes()

        packed = np.frombuffer(swizzle.pack_bitmap(bits), np.uint8)
        m = streams["maps"][(sx, sy)]
        m[:len(packed)] |= packed


# ---------------------------------------------------------------------------
# Compacted downloads: only accepted tiles cross the host link
# ---------------------------------------------------------------------------
# The full per-pass download is ~1.9 MB per 512^2 image (1 B/px of indices
# for EVERY tile). Accepted 3D tiles claim disjoint pixels, so the accepted
# subset is a small fraction - the device now emits, per pass:
#   accept bits over scan-order slots  (Ts/8 bytes)
#   count (4 bytes LE)
#   the first `cap` accepted tiles' packed rows, already in swizzle-scan
#   order (the host stream-emission order, EncoderContext.cpp:6245 scan)
# If count > cap (pathological content) the host falls back to the
# single-image full-download path for that image.

from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=None)
def _scan_perm(sx, sy, w, h):
    """Host cache: (sel0 slot ids, gids tile ids) in swizzle-scan order."""
    tw, th = 1 << sx, 1 << sy
    tx, ty, valid = swizzle.tile_scan_coords(sx, sy, w, h)
    inside = ((tx + 1) * tw <= w) & ((ty + 1) * th <= h)
    sel0 = np.flatnonzero(valid & inside)
    gids = (ty[sel0].astype(np.int64) * (w // tw) + tx[sel0]).astype(
        np.int32)
    return sel0, gids


def pass_caps(w, h, scale: int = 1):
    """Static per-pass tile caps as (scoring, download) pairs.

    Scoring cap (T/8): how many ALIVE tiles get scored - gradients claim
    most pixels of art-like content first (~10% alive tiles per 3D pass,
    counted). Download cap (T/16): how many ACCEPTED tiles' rows cross to
    the host - accepts are a subset of alive, typically 1-5% of T. An image
    exceeding either cap falls back to the dense single-image path (correct
    on any content). YAIK_ENC_CAP_FRAC / YAIK_ENC_DCAP_FRAC override.

    scale: power-of-2 multiplier on both caps (clamped to T). encode_corpus
    escalates caps when content overflows the art-tuned defaults (photo-like
    images have ~30-40% alive tiles) so the whole corpus stays on the
    batched path instead of collapsing to single-image fallbacks."""
    frac = int(os.environ.get("YAIK_ENC_CAP_FRAC", "8"))
    dfrac = int(os.environ.get("YAIK_ENC_DCAP_FRAC", "16"))
    caps = []
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        T = (h >> sy) * (w >> sx)
        caps.append((min(T, max(64, T // frac) * scale),
                     min(T, max(64, T // dfrac) * scale)))
    return tuple(caps)


def caps_fit(per_pass, caps_used, w, h):
    """Per-pass caps that FIT an unpacked compact blob with 1.5x headroom,
    rounded up to powers of 2 (compile-cache-friendly), never below the
    caps the blob was produced with, clamped at T. When the scoring cap was
    itself overflowed, the true accept count is unknown (only the first
    scap alive tiles were scored) - extrapolate it by the alive/scap ratio
    before applying the margin. Returns caps_used unchanged when nothing
    overflowed - the 'no re-dispatch needed' signal."""
    def p2(x):
        return 1 << max(0, (int(x) - 1)).bit_length()

    fit, grew = [], False
    for res, (scap, dcap) in zip(per_pass, caps_used):
        sx, sy = res["shift"]
        T = (h >> sy) * (w >> sx)
        alive = res["alive"].astype(np.int64)
        count = res["count"].astype(np.int64)
        a = int(alive.max())
        c = int((count * np.maximum(alive, scap) // scap).max())
        if a <= scap and int(count.max()) <= dcap:
            fit.append((scap, dcap))
            continue
        grew = True
        fit.append((min(T, max(scap, p2(a * 3 // 2))),
                    min(T, max(dcap, p2(c * 3 // 2)))))
    return tuple(fit) if grew else caps_used


def _compact_pass(packed, perm, cap, alive_cnt=None):
    """packed [B,T,P+9] u8 (accept at byte P); perm [Ts] i32 scan-order
    tile ids; alive_cnt [B] i32 (scoring-compaction overflow detector, 0
    when scoring ran dense). Returns flat u8
    [B, ceil8(Ts)/8 + 4 + 4 + cap*(P+9)]."""
    B, T, W = packed.shape
    Ts = perm.shape[0]
    acc = (jnp.take(packed[:, :, W - 9], perm, axis=1) > 0)       # [B,Ts]
    csum = jnp.cumsum(acc.astype(jnp.int32), axis=1)
    cnt = csum[:, -1]                                             # [B]
    targets = jnp.arange(cap, dtype=jnp.int32) + 1
    pos = jax.vmap(lambda cs: jnp.searchsorted(cs, targets))(csum)
    src = jnp.take(jnp.asarray(perm), jnp.minimum(pos, Ts - 1), axis=0)
    rows = jnp.take_along_axis(packed, src[:, :, None], axis=1)   # B,cap,W
    ts8 = -(-Ts // 8) * 8
    accp = jnp.pad(acc, ((0, 0), (0, ts8 - Ts)))
    cbits = (accp.reshape(B, ts8 // 8, 8).astype(jnp.int32)
             << jnp.arange(8, dtype=jnp.int32)).sum(-1).astype(jnp.uint8)
    if alive_cnt is None:
        alive_cnt = jnp.zeros((B,), jnp.int32)
    cnt4 = jnp.stack([(cnt >> s) & 0xFF for s in (0, 8, 16, 24)]
                     + [(alive_cnt >> s) & 0xFF for s in (0, 8, 16, 24)],
                     axis=1).astype(jnp.uint8)
    return jnp.concatenate(
        [cbits, cnt4, rows.reshape(B, -1)], axis=1)


def _tile3d_all_compact(planes_b, claims_b, qpts, pts, factors, perms,
                        caps):
    """All six 3D passes with compacted downloads AND compacted scoring:
    only the first scap alive tiles per image are scored, only the first
    dcap accepted tiles' rows cross to the host; alive_cnt rides in the
    blob so the host can fall back to the dense path when either cap
    overflows. perms: tuple of 6 scan-order tile-id arrays; caps: static
    tuple of 6 (scap, dcap) pairs."""
    B = planes_b.shape[0]
    outs = []
    for pi, (sx, sy) in enumerate(
            [(4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2)]):
        scap, dcap = caps[pi]
        packed, claims_b, alive_cnt = _resident_packed.__wrapped__(
            planes_b, claims_b, qpts, pts, factors, sx, sy,
            cap_score=scap)
        outs.append(_compact_pass(packed, perms[pi], dcap, alive_cnt))
    return jnp.concatenate(outs, axis=1), claims_b


def unpack_compact(flat, w, h, caps):
    """Host twin of _tile3d_all_compact's layout. flat [B, total] u8 ->
    per-pass list of dicts {shift, bits_scan [B,Ts] bool, count [B],
    alive [B], rows [B,dcap,P+9]} (rows beyond count are garbage; count >
    dcap OR alive > scap means a cap overflowed -> caller falls back to
    the dense path for that image)."""
    out, off = [], 0
    for pi, (sx, sy) in enumerate(swizzle.TILE3D_PASS_ORDER):
        tw, th = 1 << sx, 1 << sy
        P = tw * th
        _, gids = _scan_perm(sx, sy, w, h)
        Ts = gids.shape[0]
        nb = -(-Ts // 8)
        cap = caps[pi][1]
        cbits = flat[:, off:off + nb]
        off += nb

        def u32(o):
            return (flat[:, o].astype(np.int64)
                    | (flat[:, o + 1].astype(np.int64) << 8)
                    | (flat[:, o + 2].astype(np.int64) << 16)
                    | (flat[:, o + 3].astype(np.int64) << 24))
        cnt = u32(off)
        alive = u32(off + 4)
        off += 8
        rows = flat[:, off:off + cap * (P + 9)].reshape(-1, cap, P + 9)
        off += cap * (P + 9)
        bits = np.unpackbits(cbits, axis=1, bitorder="little")[:, :Ts]
        out.append({"shift": (sx, sy), "bits_scan": bits.astype(bool),
                    "count": cnt, "alive": alive, "rows": rows})
    return out


def emit_tile3d_streams_compact(per_pass_img, w, h, streams):
    """Host emission from compacted device outputs: identical bytes to
    emit_tile3d_streams (the rows already arrive in swizzle-scan order)."""
    for res in per_pass_img:
        sx, sy = res["shift"]
        tw, th = 1 << sx, 1 << sy
        P = tw * th
        sel0, _ = _scan_perm(sx, sy, w, h)
        tx_all, _, _ = swizzle.tile_scan_coords(sx, sy, w, h)
        bits = np.zeros(tx_all.shape[0], bool)
        bits[sel0] = res["bits_scan"]
        C = int(res["count"])
        if C:
            rows = res["rows"][:C]
            streams["color"] += rows[:, P + 3:P + 9].tobytes()
            tvals = (rows[:, P + 1].astype(np.int64)
                     | (rows[:, P + 2].astype(np.int64) << 8))
            streams["type"].extend(tvals.tolist())
            if tw > 8:
                order = []
                for xa in range(2):
                    for y in range(th):
                        for x in range(8):
                            order.append(y * tw + xa * 8 + x)
                order = np.asarray(order)
            else:
                order = np.arange(P)
            im = rows[:, :P][:, order]
            idxo = im & 63
            masko = (im >> 6).astype(bool)
            bit_arr = ((tvals >> 14) & 3) + 3
            for bit in (3, 4, 5, 6):
                tb = bit_arr == bit
                if tb.any():
                    streams[bit] += idxo[tb][~masko[tb]].astype(
                        np.uint8).tobytes()

        packed = np.frombuffer(swizzle.pack_bitmap(bits), np.uint8)
        m = streams["maps"][(sx, sy)]
        m[:len(packed)] |= packed
