"""Batched device encode: score a whole corpus batch per dispatch.

Single-image device encode pays per-dispatch and per-transfer costs;
batching vmaps every scoring dispatch over B same-sized images - 2 device
calls total regardless of B (one fused gradient bundle + one bundle of all
six resident 3D passes), planes and claims stay on device, and each bundle
downloads ONE packed u8 array. The O(tiles) per-image emission/entropy runs
on host. RGBA is supported: the alpha/mipmap chunks are a per-image host
stage (encode_image emits them; device scoring only sees the RGB planes).
Streams are byte-identical to encode_image (tested).
"""
from __future__ import annotations

import os
from functools import lru_cache, partial

import numpy as np

import jax
import jax.numpy as jnp

from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder import device_pipeline as devp
from yaik_tpu.encoder import jax_scoring
from yaik_tpu.encoder.context import EncoderConfig, encode_image
from yaik_tpu.format import swizzle


@lru_cache(maxsize=None)
def _grad_batch_fn(reject_factor):
    # planes travel as u8 (4x less than int32) and claims are
    # materialized on device - the cast/zeros are free next to the transfer
    def core(p8):
        p = p8.astype(jnp.int32)
        c = jnp.zeros(p8.shape, bool)
        accepts, claims = jax_scoring.gradient_all_device.__wrapped__(
            p, c, reject_factor)
        packed = jnp.concatenate([a.reshape(-1).astype(jnp.uint8)
                                  for a in accepts])
        return packed, claims
    return jax.jit(jax.vmap(core))


@jax.jit
def _tile3d_all_batch(planes8_b, claims_b, qpts, pts, factors):
    return devp._tile3d_all.__wrapped__(
        planes8_b.astype(jnp.int32), claims_b, qpts, pts, factors)


@lru_cache(maxsize=None)
def _all_batch_fn(reject_factor):
    """Gradient + all-six-3D scoring in ONE dispatch per batch: one host
    round trip instead of two (claims flow gradient -> 3D in-graph). The
    gradient stage is vmapped; the 3D stage is natively batched (its
    scoring kernel wants the flattened B*T tile axis, not vmap)."""
    def core(p8_b, qpts, pts, factors):
        B = p8_b.shape[0]
        p_b = p8_b.astype(jnp.int32)
        c_b = jnp.zeros(p8_b.shape, bool)
        accepts_b, claims_b = jax.vmap(
            lambda p, c: jax_scoring.gradient_all_device.__wrapped__(
                p, c, reject_factor))(p_b, c_b)
        packed_g = jnp.concatenate(
            [a.reshape(B, -1).astype(jnp.uint8) for a in accepts_b], axis=1)
        packed_3d, _ = devp._tile3d_all.__wrapped__(
            p_b, claims_b, qpts, pts, factors)
        return packed_g, packed_3d
    return jax.jit(core, static_argnums=())


@lru_cache(maxsize=None)
def _all_batch_compact_fn(reject_factor, caps):
    """Like _all_batch_fn but with compacted 3D downloads: accept bitmaps
    + only the accepted tiles' rows cross to the host (~4x less than the
    full per-tile download). Gradient accepts and the 3D blob are fused
    into ONE u8 output array so the host pays a single fetch per batch."""
    def core(p8_b, qpts, pts, factors, perms):
        B = p8_b.shape[0]
        p_b = p8_b.astype(jnp.int32)
        c_b = jnp.zeros(p8_b.shape, bool)
        accepts_b, claims_b = jax.vmap(
            lambda p, c: jax_scoring.gradient_all_device.__wrapped__(
                p, c, reject_factor))(p_b, c_b)
        packed_g = jnp.concatenate(
            [a.reshape(B, -1).astype(jnp.uint8) for a in accepts_b], axis=1)
        packed_3d, _ = devp._tile3d_all_compact(
            p_b, claims_b, qpts, pts, factors, perms, caps)
        return jnp.concatenate([packed_g, packed_3d], axis=1)
    return jax.jit(core)


def _grad_packed_len(w, h):
    """Byte length of the fused blob's gradient-accepts prefix."""
    return sum((h >> sy) * (w >> sx)
               for (sx, sy) in swizzle.GRADIENT_PASS_ORDER)


@lru_cache(maxsize=None)
def _perms_device(w, h):
    """Device-resident swizzle-scan tile-id permutations, uploaded once
    per image shape instead of once per dispatch."""
    return tuple(
        jax.device_put(np.asarray(devp._scan_perm(sx, sy, w, h)[1]))
        for (sx, sy) in swizzle.TILE3D_PASS_ORDER)


class _Precomputed:
    """Per-image scoring results injected into the standard emission path.
    Either t3_results (full per-tile arrays) or t3_compact (accept bitmaps
    + compacted scan-order rows) is set."""

    def __init__(self, grad_accepts, t3_results, t3_compact=None):
        self.grad_accepts = grad_accepts
        self.t3_results = t3_results
        self.t3_compact = t3_compact


# Device-scoring pixel ceiling PER DISPATCH. Images beyond it score on
# device in row BANDS (encode_image_banded) - the scoring transients stay
# O(band), bytes identical. Memory does not bind it on an H100: XLA's
# memory analysis of one 2 MPix dispatch (8 images of 512^2) is 94 MB of
# arguments, outputs and temporaries. Larger dispatches are not timed.
DEVICE_SCORE_MAX_PIX = 2 * 1024 * 1024


def encode_batch(images, bank: bankmod.Bank,
                 config: EncoderConfig | None = None) -> list[bytes]:
    """Encode B same-sized RGB images with batched device scoring.
    Images above DEVICE_SCORE_MAX_PIX fall back to host scoring."""
    cfg = config or EncoderConfig()
    imgs = [np.asarray(im) for im in images]
    h, w = imgs[0].shape[:2]
    if any(im.shape != imgs[0].shape for im in imgs):
        raise ValueError("encode_batch requires same-shaped images")
    if imgs[0].ndim != 3 or imgs[0].shape[2] not in (3, 4):
        raise ValueError("expected [h, w, 3|4] u8 images")
    if h % 8 or w % 8:
        raise ValueError("image dimensions must be multiples of 8")
    if h * w > DEVICE_SCORE_MAX_PIX:
        # banded device scoring: temps stay O(band) (VERDICT r3 #2)
        return [encode_image_banded(im, bank, cfg) for im in imgs]
    B = len(imgs)

    planes_b = jax.device_put(np.ascontiguousarray(np.stack(
        [im[:, :, :3].transpose(2, 0, 1) for im in imgs])))

    packed, claims_b = _grad_batch_fn(cfg.reject_factor)(planes_b)
    packed = np.asarray(packed)
    grad_accepts, off = [], 0
    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
        nty, ntx = h >> sy, w >> sx
        grad_accepts.append(packed[:, off:off + nty * ntx]
                            .reshape(B, nty, ntx).astype(bool))
        off += nty * ntx

    tables = devp.bank_device_tables(bank)
    packed_all, claims_b = _tile3d_all_batch(planes_b, claims_b, *tables)
    packed_all = np.asarray(packed_all)
    t3_b, off = [], 0
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        tw, th = 1 << sx, 1 << sy
        P = tw * th
        T = (h // th) * (w // tw)
        n = T * (P + 9)
        pk = packed_all[:, off:off + n].reshape(B, T, P + 9)
        off += n
        t3_b.append({"shift": (sx, sy),
                     "per_img": [devp._unpack_pass(pk[i], P)
                                 for i in range(B)]})

    streams = []
    for i in range(B):
        pre = _Precomputed(
            [a[i] for a in grad_accepts],
            [{"shift": res["shift"],
              "idx": res["per_img"][i][0], "mask": res["per_img"][i][1],
              "accept": res["per_img"][i][2], "type": res["per_img"][i][3],
              "bbox": res["per_img"][i][4]}
             for res in t3_b])
        streams.append(encode_image(imgs[i], bank, cfg, engine="precomputed",
                                    precomputed=pre))
    return streams


_MESH_FN_CACHE: dict = {}


def _all_batch_compact_mesh_fn(reject_factor, caps, mesh):
    """Mesh-DP variant: the scoring bundle shard_mapped over the mesh's
    "data" axis (one image-batch shard per device; scoring is per-image-
    parallel so no collectives are needed and the output is bit-identical
    to the unsharded dispatch - validated by the multichip dryrun axis 6
    and tests/test_encoder_compact.py)."""
    key = (reject_factor, caps, mesh.axis_names,
           tuple(d.id for d in mesh.devices.flat))
    hit = _MESH_FN_CACHE.get(key)
    if hit is not None:
        return hit
    from jax.sharding import PartitionSpec as P
    core = _all_batch_compact_fn(reject_factor, caps).__wrapped__

    def sharded(p8_b, qpts, pts, factors, perms):
        return jax.shard_map(
            core, mesh=mesh,
            in_specs=(P("data"), P(), P(), P(),
                      tuple(P() for _ in perms)),
            out_specs=P("data"))(
                p8_b, qpts, pts, factors, perms)

    fn = jax.jit(sharded)
    _MESH_FN_CACHE[key] = fn
    return fn


def _dispatch_batch(imgs, claims_shape, cfg, tables, caps=None, mesh=None):
    """Upload one padded batch and enqueue gradient + 3D scoring (compacted
    3D downloads, one fused output array); start the device->host copy
    without blocking, so it overlaps the host emission of the previous
    batch. mesh: shard the image batch
    over its "data" axis (batch must divide by the mesh size)."""
    h, w = imgs[0].shape[:2]
    caps = caps or devp.pass_caps(w, h)
    stacked = np.ascontiguousarray(np.stack(
        [im[:, :, :3].transpose(2, 0, 1) for im in imgs]))
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        if len(imgs) % int(mesh.devices.size):
            # fail here with a clear message instead of an opaque
            # shard_map sharding error deep inside jit (ADVICE r4)
            raise ValueError(
                f"mesh encode: the mesh's {int(mesh.devices.size)} "
                f"devices must divide the batch size {len(imgs)} - pass "
                f"a batch_size that is a multiple of the mesh size")
        planes_b = jax.device_put(stacked, NamedSharding(mesh, P("data")))
        packed_all = _all_batch_compact_mesh_fn(cfg.reject_factor, caps,
                                                mesh)(
            planes_b, *tables, _perms_device(w, h))
    else:
        planes_b = jax.device_put(stacked)
        packed_all = _all_batch_compact_fn(cfg.reject_factor, caps)(
            planes_b, *tables, _perms_device(w, h))
    packed_all.copy_to_host_async()
    return packed_all


def _emit_batch(imgs, packed_all, bank, cfg, caps=None):
    """Unpack one batch's fused compacted device output and run host
    emission per image. An image whose accepted-tile count overflows a
    pass cap (pathological content) falls back to the single-image
    full-download device path - still byte-identical."""
    h, w = imgs[0].shape[:2]
    caps = caps or devp.pass_caps(w, h)
    flat = np.asarray(packed_all)
    G = _grad_packed_len(w, h)
    per_pass = devp.unpack_compact(flat[:, G:], w, h, caps)
    return _emit_from_unpacked(imgs, flat[:, :G], per_pass, caps, bank, cfg)


def _emit_from_unpacked(imgs, packed, per_pass, caps, bank, cfg):
    B = len(imgs)
    h, w = imgs[0].shape[:2]
    grad_accepts, off = [], 0
    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
        nty, ntx = h >> sy, w >> sx
        grad_accepts.append(packed[:, off:off + nty * ntx]
                            .reshape(B, nty, ntx).astype(bool))
        off += nty * ntx
    from yaik_tpu.encoder.context import _ZstdBatch
    streams: list = [None] * B
    pres = {}
    for i in range(B):
        if any(int(res["count"][i]) > dcap or int(res["alive"][i]) > scap
               for res, (scap, dcap) in zip(per_pass, caps)):
            # cap-overflow fallback re-scores on device: keep jax off
            # worker threads by running these on the caller thread
            streams[i] = encode_image(imgs[i], bank, cfg, engine="device")
            continue
        pres[i] = _Precomputed(
            [a[i] for a in grad_accepts], None,
            t3_compact=[{"shift": res["shift"],
                         "bits_scan": res["bits_scan"][i],
                         "count": res["count"][i],
                         "rows": res["rows"][i]}
                        for res in per_pass])
    from yaik_tpu.utils import profiler
    nw = int(os.environ.get("YAIK_EMIT_WORKERS", "0") or 0)
    if nw > 1 and len(pres) > 1:
        # multi-core hosts fan the WHOLE per-image emission (palette,
        # gtil/dyn1d native codecs, stream assembly AND the zstd flush)
        # over threads - every native call releases the GIL and each
        # image's state is independent, so the bytes are identical
        # (tests/test_zstd_workers.py pins this). The production encode
        # model becomes min(device scoring, N_cores x ~59 MPix/s of
        # full emit), not just the zstd term.
        from concurrent.futures import ThreadPoolExecutor

        def emit_one(i):
            zbi = _ZstdBatch()
            mk = encode_image(imgs[i], bank, cfg, engine="precomputed",
                              precomputed=pres[i], _defer=zbi)
            zbi.run()
            return mk()

        order = sorted(pres)
        with ThreadPoolExecutor(nw) as pool:
            for i, st in zip(order, pool.map(emit_one, order)):
                streams[i] = st
        return streams
    # single-core path: ONE shared zstd batch for the whole image batch -
    # every stream compresses back-to-back at the end so the level-18
    # match-finder workspace stays cache-warm across the batch (bytes
    # identical - each stream is an independent one-shot)
    zb = _ZstdBatch()
    mks = {}
    for i in sorted(pres):
        mks[i] = encode_image(imgs[i], bank, cfg, engine="precomputed",
                              precomputed=pres[i], _defer=zb)
    with profiler.stage("emit:zstd-flush"):
        zb.run()
    with profiler.stage("emit:assemble"):
        for i, mk in mks.items():
            streams[i] = mk()
    return streams


# Learned per-shape caps (see pass_caps/caps_fit): photo-like corpora
# overflow the art-tuned T/8 caps on every image; once a corpus teaches us
# its caps, later batches (and later corpora in the same process) dispatch
# with caps that fit on the first try.
_CAP_STATE: dict = {}


def _drain_adaptive(p_imgs, pall, caps, bank, cfg, tables, mesh=None):
    """Unpack one batch; when any image overflows its caps, grow them to
    fit (caps_fit, remembered in _CAP_STATE) and re-dispatch the batch
    with roomier caps - batched, unlike the per-image single-image
    fallback. Terminates: caps grow monotonically and clamp at T, and
    counts are <= T."""
    h, w = p_imgs[0].shape[:2]
    key = (h, w, cfg.reject_factor)
    G = _grad_packed_len(w, h)
    while True:
        flat = np.asarray(pall)
        per_pass = devp.unpack_compact(flat[:, G:], w, h, caps)
        fit = devp.caps_fit(per_pass, caps, w, h)
        if fit == caps:
            return _emit_from_unpacked(p_imgs, flat[:, :G], per_pass, caps,
                                       bank, cfg)
        caps = tuple((max(s1, s2), max(d1, d2)) for (s1, d1), (s2, d2)
                     in zip(fit, _CAP_STATE.get(key, fit)))
        _CAP_STATE[key] = caps
        pall = _dispatch_batch(p_imgs, None, cfg, tables, caps, mesh=mesh)


def encode_corpus(images, bank: bankmod.Bank,
                  config: EncoderConfig | None = None,
                  batch_size: int = 8, mesh=None) -> list[bytes]:
    """Encode a corpus of RGB images with a pipelined device/host schedule:
    while the accelerator scores batch k+1, the host emits batch k's
    streams. Images are
    grouped by shape; short final batches are padded to batch_size so every
    dispatch reuses the same compiled executable. Output order matches the
    input order; streams are byte-identical to encode_image (tested)."""
    cfg = config or EncoderConfig()
    if mesh is not None and batch_size % int(mesh.devices.size):
        raise ValueError(
            f"encode_corpus(mesh=...): batch_size {batch_size} must be a "
            f"multiple of the mesh's {int(mesh.devices.size)} devices")
    imgs = [np.asarray(im) for im in images]
    for im in imgs:
        if im.ndim != 3 or im.shape[2] not in (3, 4):
            raise ValueError("expected [h, w, 3|4] u8 images")
        if im.shape[0] % 8 or im.shape[1] % 8:
            raise ValueError("image dimensions must be multiples of 8")
    tables = devp.bank_device_tables(bank)
    results: list[bytes | None] = [None] * len(imgs)

    groups: dict = {}
    for i, im in enumerate(imgs):
        groups.setdefault(im.shape, []).append(i)

    # Pipeline depth D (default 2): up to D batches are in flight on the
    # dispatch worker while the main thread emits. At depth 1 the schedule
    # degenerates to "upload k+1, then wait for k": the upload of k+1, the
    # device compute of k+1, and the download of k never overlap the host
    # emit of k-1 because only one stage separates dispatch from drain.
    # With D=2 the transfers, the device, and the host zstd/palette ctypes
    # calls (GIL-released) all run concurrently even on a 1-core host.
    # Depth is bounded: each in-flight batch holds one
    # compacted output buffer (~1.3 MB host + its device buffers).
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    depth = max(1, int(os.environ.get("YAIK_ENC_DEPTH", "2")))
    pool = ThreadPoolExecutor(1)
    try:
        for shape, idxs in groups.items():
            if shape[0] * shape[1] > DEVICE_SCORE_MAX_PIX:
                for i in idxs:    # banded device scoring (VERDICT r3 #2)
                    results[i] = encode_image_banded(imgs[i], bank, cfg)
                continue
            key = (shape[0], shape[1], cfg.reject_factor)
            base_caps = devp.pass_caps(shape[1], shape[0])
            inflight: deque = deque()

            def drain_one():
                p_chunk, p_imgs, p_fut, p_caps = inflight.popleft()
                for i, st in zip(p_chunk, _drain_adaptive(
                        p_imgs, p_fut.result(), p_caps, bank, cfg,
                        tables, mesh)):
                    results[i] = st

            for s in range(0, len(idxs), batch_size):
                chunk = idxs[s:s + batch_size]
                batch_imgs = [imgs[i] for i in chunk]
                pad = batch_size - len(batch_imgs)
                caps = _CAP_STATE.get(key, base_caps)
                fut = pool.submit(_dispatch_batch,
                                  batch_imgs + [batch_imgs[0]] * pad,
                                  shape, cfg, tables, caps, mesh)
                inflight.append((chunk, batch_imgs + [batch_imgs[0]] * pad,
                                 fut, caps))
                if len(inflight) > depth:
                    drain_one()
            while inflight:
                drain_one()
    finally:
        pool.shutdown(wait=True)
    return results


def _band_rows(w: int, h: int) -> int:
    """Largest band height (multiple of 16 rows) whose pixel count fits the
    per-dispatch ceiling. 16-row alignment keeps every gradient (<=16 px)
    and 3D (<=8 px) tile fully inside one band, and claims interactions
    are tile-local, so per-band scoring grids equal full-image scoring
    grids exactly; emission re-derives the swizzle-scan stream order from
    the reassembled full grids, so band merging is plain concatenation."""
    rows = max(16, (DEVICE_SCORE_MAX_PIX // w) & ~15)
    return min(rows, h)


# A band is scored with ONE extra pixel row below it (halo): the bottom
# corners of the band's last tile row sample the pixel row at y0 + bh
# (gradient_pass_device clamps ys at planes_h - 1, so without the halo a
# band-interior edge would clamp to the wrong pixel and accepts near band
# boundaries diverge from full-image scoring - caught by the banded
# byte-identity test). Grid sizes are unchanged: bh % 16 == 0 means
# (bh + 1) // th == bh // th for every tile height.


def encode_image_banded(img, bank: bankmod.Bank,
                        config: EncoderConfig | None = None) -> bytes:
    """Device-scored encode for images past the per-dispatch pixel ceiling
    (VERDICT r3 #2 / BASELINE config 4): the image is scored in horizontal
    bands on the accelerator - the [T, P, 3] scoring temps are O(band),
    not O(image) - and the per-band accept/type/index grids concatenate
    into full-image grids for the standard host emission. Byte-identical
    to encode_image(engine="host") (tested)."""
    cfg = config or EncoderConfig()
    img = np.asarray(img)
    h, w = img.shape[:2]
    if h % 8 or w % 8:
        raise ValueError("image dimensions must be multiples of 8")
    tables = devp.bank_device_tables(bank)
    band = _band_rows(w, h)

    fn = _all_batch_fn(cfg.reject_factor)
    grad_parts: list = []   # per band: list of 7 [ntyb, ntx] bool
    t3_parts: list = []     # per band: list of 6 (idx, mask, accept, typ, bbox)
    y0 = 0
    while y0 < h:
        bh = min(band, h - y0)
        if (h - y0 - bh) and (h - y0 - bh) < 16:
            bh = h - y0          # absorb a sub-16 remainder into this band
        halo = 1 if y0 + bh < h else 0
        sl = np.ascontiguousarray(
            img[y0:y0 + bh + halo, :, :3].transpose(2, 0, 1))[None]
        packed_g, packed_3d = fn(jax.device_put(sl), *tables)
        packed_g.copy_to_host_async()
        pg = np.asarray(packed_g)[0]
        p3 = np.asarray(packed_3d)[0]
        ga, off = [], 0
        for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
            nty, ntx = bh >> sy, w >> sx
            ga.append(pg[off:off + nty * ntx].reshape(nty, ntx).astype(bool))
            off += nty * ntx
        grad_parts.append(ga)
        t3b, off = [], 0
        for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
            tw, th = 1 << sx, 1 << sy
            P = tw * th
            T = (bh // th) * (w // tw)
            n = T * (P + 9)
            t3b.append(devp._unpack_pass(p3[off:off + n].reshape(T, P + 9),
                                         P))
            off += n
        t3_parts.append(t3b)
        y0 += bh

    grad_accepts = [np.concatenate([b[k] for b in grad_parts], axis=0)
                    for k in range(7)]
    t3_results = []
    for k, (sx, sy) in enumerate(swizzle.TILE3D_PASS_ORDER):
        idx = np.concatenate([b[k][0] for b in t3_parts], axis=0)
        mask = np.concatenate([b[k][1] for b in t3_parts], axis=0)
        accept = np.concatenate([b[k][2] for b in t3_parts], axis=0)
        typ = np.concatenate([b[k][3] for b in t3_parts], axis=0)
        bbox = np.concatenate([b[k][4] for b in t3_parts], axis=0)
        t3_results.append({"shift": (sx, sy), "idx": idx, "mask": mask,
                           "accept": accept, "type": typ, "bbox": bbox})
    pre = _Precomputed(grad_accepts, t3_results)
    return encode_image(img, bank, cfg, engine="precomputed",
                        precomputed=pre)


def encode_image_banded_mesh(img, bank: bankmod.Bank,
                             config: EncoderConfig | None = None,
                             mesh=None) -> bytes:
    """encode_image_banded with ALL bands scored in ONE mesh-sharded
    dispatch: the image splits into n_devices equal 16-row-aligned bands
    (each with its one-row halo, the bottom padded by replicating the
    last row - exactly the clamp the full-image scorer applies at the
    image edge, so accepts match bit-for-bit), the band axis shard_maps
    over the mesh's "data" axis, and the per-band grids concatenate for
    the standard host emission. Byte-identical to encode_image host
    scoring (tested on the CPU mesh). This is BASELINE config 4 at mesh
    scale: a 4K image's full multi-scale tile search across chips."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = config or EncoderConfig()
    img = np.asarray(img)
    h, w = img.shape[:2]
    if h % 8 or w % 8:
        raise ValueError("image dimensions must be multiples of 8")
    if h % 16:
        # partial-bottom tile rows use CEIL grid counts in emission
        # (accept_grid) which the floor-count band grids cannot represent;
        # %8-only heights take the host or single-chip device path
        raise ValueError("banded mesh encode requires height % 16 == 0")
    n = int(mesh.devices.size)
    bh = (-(-h // n) + 15) & ~15
    Hp = n * bh
    src = img[:, :, :3]
    padded = np.concatenate(
        [src, np.repeat(src[-1:], Hp + 1 - h, axis=0)], axis=0)
    bands = np.stack([padded[i * bh:(i + 1) * bh + 1] for i in range(n)])
    p8 = np.ascontiguousarray(bands.transpose(0, 3, 1, 2))

    core = _all_batch_fn(cfg.reject_factor).__wrapped__
    tables = devp.bank_device_tables(bank)
    fn = jax.jit(jax.shard_map(
        core, mesh=mesh,
        in_specs=(P("data"), P(), P(), P()),
        out_specs=(P("data"), P("data"))))
    pg_b, p3_b = fn(jax.device_put(p8, NamedSharding(mesh, P("data"))),
                    *tables)
    pg_b, p3_b = np.asarray(pg_b), np.asarray(p3_b)

    grad_accepts = []
    off = 0
    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
        nty, ntx = bh >> sy, w >> sx
        full = pg_b[:, off:off + nty * ntx].reshape(n * nty, ntx)
        grad_accepts.append(full[: h >> sy].astype(bool))
        off += nty * ntx
    t3_results = []
    off = 0
    for (sx, sy) in swizzle.TILE3D_PASS_ORDER:
        tw, th = 1 << sx, 1 << sy
        P_ = tw * th
        T = (bh // th) * (w // tw)
        nfull = (h // th) * (w // tw)
        nb = T * (P_ + 9)
        per = [devp._unpack_pass(p3_b[i, off:off + nb].reshape(T, P_ + 9),
                                 P_) for i in range(n)]
        off += nb
        t3_results.append({
            "shift": (sx, sy),
            "idx": np.concatenate([p[0] for p in per])[:nfull],
            "mask": np.concatenate([p[1] for p in per])[:nfull],
            "accept": np.concatenate([p[2] for p in per])[:nfull],
            "type": np.concatenate([p[3] for p in per])[:nfull],
            "bbox": np.concatenate([p[4] for p in per])[:nfull]})
    pre = _Precomputed(grad_accepts, t3_results)
    return encode_image(img, bank, cfg, engine="precomputed",
                        precomputed=pre)
