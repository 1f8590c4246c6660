"""LUT-bank mining: build Bank3D point clouds from a training corpus.

The reference's research workflow (SURVEY section 3.4): capture mode dumps
each unclaimed full tile's normalized RGB cloud to `tile3D/*.lut`
(Correlation3DSearch, EncoderContext.cpp:6350-6433), then evaluateLUT mode
re-runs the encoder per candidate to measure coverage (:8904-8985). This
module reproduces that loop in-process:

  capture_clouds: normalized 64-point clouds of gradient-unclaimed 8x8 tiles
  evaluate_candidates: greedy coverage selection - repeatedly add the
    candidate cloud that newly covers the most captured tiles under the
    reference's accept gate (approximated by 3-bit nearest-point error)
  mine_bank: corpus -> Bank3D files loadable by both encoders
"""
from __future__ import annotations

import os

import numpy as np

from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder import gradient
from yaik_tpu.format import swizzle


def capture_clouds(rgb: np.ndarray, reject_factor: int = 3,
                   engine: str = "host"):
    """Run the gradient passes, then capture normalized clouds of the
    leftover full 8x8 tiles (the reference captures pixelsInTile >= 64).
    engine="device": the claim map comes from the fused device gradient
    bundle (jax_scoring.gradient_all_device - the same scoring whose
    byte parity with the host passes the encode tests), so corpus-scale
    capture jobs ride the accelerator instead of the host scorer."""
    h, w = rgb.shape[:2]
    planes = rgb[:, :, :3].transpose(2, 0, 1).astype(np.int32)
    claims = np.zeros((3, h, w), bool)
    if engine == "device":
        import jax.numpy as jnp

        from yaik_tpu.encoder import jax_scoring
        _, claims_d = jax_scoring.gradient_all_device(
            jnp.asarray(planes), jnp.asarray(claims), reject_factor)
        claims = np.asarray(claims_d)
    else:
        mapped = np.zeros((3, h + 1, w + 1), bool)
        for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
            gradient.run_pass(planes, claims, mapped, sx, sy,
                              reject_factor, 250)

    clouds = []
    for y in range(0, h, 8):
        for x in range(0, w, 8):
            if claims[:, y:y + 8, x:x + 8].any():
                continue
            tile = planes[:, y:y + 8, x:x + 8].reshape(3, -1).T  # [64,3]
            mn, mx = tile.min(0), tile.max(0)
            d = mx - mn
            if (d == 0).sum() >= 2:
                continue
            nvec = np.where(d > 0, (1 << 20) // np.maximum(d, 1), 0)
            r = (tile - mn) * nvec
            fr = r.astype(np.float32) / np.float32(1 << 20)
            c = (fr * np.float32(63)).astype(np.uint8)
            clouds.append(c)
    return clouds


def _covers(cloud_pts: np.ndarray, tiles: np.ndarray, gate_px: int = 75):
    """Accept proxy mirroring the reference gate (max-channel error <= 5,
    <= 3 violating pixels): per-pixel squared nearest-point distance at the
    most permissive (6-bit, 64-point) depth in the 64-cube; tile covered
    when at most 3 pixels exceed gate_px. tiles: [n, 64, 3]."""
    pts = cloud_pts.astype(np.int32)       # 6-bit: all 64 points
    d = ((tiles[:, :, None, :].astype(np.int32) - pts[None, None, :, :]) ** 2
         ).sum(-1).min(-1)            # [n, 64]
    return (d > gate_px).sum(axis=1) <= 3


def _covers_device(cands: np.ndarray, tiles: np.ndarray, gate_px: int):
    """The full [k, n] coverage matrix on the accelerator: one jit,
    candidates chunked via lax.map so the [kc, n, 64px, 64pt] distance
    transient stays bounded. Integer-exact (i32 throughout), so the
    result equals the numpy _covers matrix bit-for-bit - tested. On a
    corpus-scale mine (k=256, n~50k) the numpy loop is minutes of host
    time; the device matrix is one dispatch."""
    import jax
    import jax.numpy as jnp

    k = cands.shape[0]
    n = tiles.shape[0]
    kc = 8
    # chunk the TILE axis as well so the worst-case transient is bounded
    # by construction (~kc * nc * 64px * 64pt * 4B ~= 0.5 GB even if the
    # backend materializes the broadcast instead of fusing it into the
    # min/sum consumers) rather than by fusion behavior at corpus scale
    # (n ~ 50k would otherwise imply a tens-of-GB unfused intermediate) -
    # ADVICE r4
    nc = 4096
    padk = (-k) % kc
    padn = (-n) % nc
    cp = jnp.asarray(np.pad(cands, ((0, padk), (0, 0), (0, 0)))
                     .astype(np.int32))
    tl = jnp.asarray(np.pad(tiles, ((0, padn), (0, 0), (0, 0)))
                     .astype(np.int32))            # [n+padn, 64, 3]

    @jax.jit
    def matrix(cp, tl):
        def chunk(ij):
            i, j = ij[0], ij[1]
            c = jax.lax.dynamic_slice_in_dim(cp, i * kc, kc)  # [kc,64,3]
            t = jax.lax.dynamic_slice_in_dim(tl, j * nc, nc)  # [nc,64,3]
            d = ((t[None, :, :, None, :] - c[:, None, None, :, :]) ** 2
                 ).sum(-1).min(-1)                 # [kc, nc, 64px]
            return (d > gate_px).sum(-1) <= 3
        nk, nn = (k + padk) // kc, (n + padn) // nc
        ids = jnp.stack(
            [jnp.repeat(jnp.arange(nk), nn),
             jnp.tile(jnp.arange(nn), nk)], axis=1)
        return jax.lax.map(chunk, ids)             # [nk*nn, kc, nc]

    nk, nn = (k + padk) // kc, (n + padn) // nc
    m = np.asarray(matrix(cp, tl)).reshape(nk, nn, kc, nc)
    return m.transpose(0, 2, 1, 3).reshape(nk * kc, nn * nc)[:k, :n]


def evaluate_candidates(clouds, max_tables=12, gate_px=75,
                        max_candidates=256, engine="host"):
    """Greedy max-coverage selection of candidate clouds. engine="device"
    computes the coverage matrix on the accelerator (bit-identical)."""
    if not clouds:
        return []
    tiles = np.stack(clouds)                       # [n, 64, 3]
    # candidates = a subsample of the captures themselves
    step = max(1, len(clouds) // max_candidates)
    cand_idx = list(range(0, len(clouds), step))
    cands = [bankmod.sort_palette_morton(clouds[i]) for i in cand_idx]

    if engine == "device":
        cover = _covers_device(np.stack(cands), tiles, gate_px)
    else:
        cover = np.stack([_covers(c, tiles, gate_px)
                          for c in cands])         # [k, n]
    covered = np.zeros(len(tiles), bool)
    picked = []
    for _ in range(max_tables):
        gains = (cover & ~covered[None, :]).sum(axis=1)
        best = int(gains.argmax())
        if gains[best] == 0:
            break
        picked.append(cands[best])
        covered |= cover[best]
    return picked


def mine_bank(images, out_dir, max_tables=12, checkpoint=None,
              engine="host", max_candidates=256):
    """images: list of [h,w,3+] u8 arrays. Writes Bank3D-format files named
    like the reference's hardcoded list so both encoders can load them.

    checkpoint: optional .npz path - the capture phase (the long part of a
    corpus-scale mining job) saves progress after every image and resumes
    where it left off (SURVEY section 5: corpus datagen jobs checkpoint
    batch progress; the reference's closest analog is globalStats.bin)."""
    clouds = []
    start = 0
    if checkpoint and os.path.exists(checkpoint):
        saved = np.load(checkpoint)
        start = int(saved["done"])
        clouds = [saved[f"c{i}"] for i in range(int(saved["count"]))]
    for k in range(start, len(images)):
        clouds.extend(capture_clouds(np.asarray(images[k]),
                                     engine=engine))
        if checkpoint:
            np.savez(checkpoint + ".tmp.npz", done=k + 1, count=len(clouds),
                     **{f"c{i}": c for i, c in enumerate(clouds)})
            os.replace(checkpoint + ".tmp.npz", checkpoint)
    picked = evaluate_candidates(clouds, max_tables=max_tables,
                                 max_candidates=max_candidates,
                                 engine=engine)
    os.makedirs(out_dir, exist_ok=True)
    for name, cloud in zip(bankmod.BANK_FILE_NAMES, picked):
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(bytes([len(cloud) & 0xFF]))
            f.write(cloud[:, 0].tobytes())
            f.write(cloud[:, 1].tobytes())
            f.write(cloud[:, 2].tobytes())
    return len(picked), len(clouds)


# ---------------------------------------------------------------------------
# 2D bank mining: the reference's isCaptureMode2D workflow
# (Correlation2DSearch, EncoderContext.cpp:6965-6982: tiles with
# pixelsInTile >= 32 dump their normalized (a, b) samples as 64x64 PNG
# point maps into tile2DImg/ - exactly the Bank2D input format).
# ---------------------------------------------------------------------------

def capture_clouds_2d(rgb: np.ndarray, reject_factor: int = 3):
    """Capture normalized pair-channel clouds of 8x8 tiles left unclaimed by
    the gradient passes, per plane mode (RG/GB/RB). Returns a list of
    [n <= 64, 2] u8 point sets (deduplicated, like the PNG round trip)."""
    from yaik_tpu.encoder.corr2d import PAIR
    h, w = rgb.shape[:2]
    planes = rgb[:, :, :3].transpose(2, 0, 1).astype(np.int32)
    claims = np.zeros((3, h, w), bool)
    mapped = np.zeros((3, h + 1, w + 1), bool)
    for (sx, sy) in swizzle.GRADIENT_PASS_ORDER:
        gradient.run_pass(planes, claims, mapped, sx, sy, reject_factor, 250)

    clouds = []
    for mode in (0, 1, 2):
        pa, pb = PAIR[mode]
        for y in range(0, h, 8):
            for x in range(0, w, 8):
                if (claims[pa, y:y + 8, x:x + 8]
                        | claims[pb, y:y + 8, x:x + 8]).any():
                    continue
                a = planes[pa, y:y + 8, x:x + 8].reshape(-1)
                b = planes[pb, y:y + 8, x:x + 8].reshape(-1)
                mna, mxa = int(a.min()), int(a.max())
                mnb, mxb = int(b.min()), int(b.max())
                if mxa == mna or mxb == mnb:
                    continue
                na = (1 << 20) // (mxa - mna)
                nb = (1 << 20) // (mxb - mnb)
                fa = ((a - mna) * na).astype(np.float32) / np.float32(1 << 20)
                fb = ((b - mnb) * nb).astype(np.float32) / np.float32(1 << 20)
                ia = (fa * np.float32(63)).astype(np.uint8)
                ib = (fb * np.float32(63)).astype(np.uint8)
                pts = np.unique(np.stack([ia, ib], 1), axis=0)
                clouds.append(pts[:64])
    return clouds


def _covers_2d(cloud_pts: np.ndarray, tiles, gate: int = 36):
    """2D accept proxy: nearest-point squared distance in the 64x64 plane
    (the real gate is the /128 reconstruction error <= 6; squared-distance
    36 is its scale-free stand-in, like _covers for 3D)."""
    out = np.empty(len(tiles), bool)
    p = cloud_pts.astype(np.int32)
    for i, t in enumerate(tiles):
        d = ((t[:, None, :].astype(np.int32) - p[None, :, :]) ** 2
             ).sum(-1).min(-1)
        out[i] = (d > gate).sum() <= 3
    return out


def _covers2d_device(cands, clouds, gate: int = 36):
    """The 2D [k, n] coverage matrix on the accelerator. 2D clouds are
    variable-length (deduplicated point sets <= 64), so both axes pad to
    64 points with masks: pad TILE points are excluded from the violation
    count; pad CANDIDATE points sit at (4096, 4096) so they are never the
    nearest. Bit-identical to the _covers_2d loop (tested)."""
    import jax
    import jax.numpy as jnp

    def padset(ps):
        arr = np.full((64, 2), 4096, np.int32)
        arr[: len(ps)] = ps
        m = np.zeros(64, bool)
        m[: len(ps)] = True
        return arr, m

    cp = np.stack([padset(c)[0] for c in cands])           # [k,64,2]
    tp_arr, tp_msk = zip(*(padset(t) for t in clouds))
    tl = jnp.asarray(np.stack(tp_arr))                     # [n,64,2]
    tm = jnp.asarray(np.stack(tp_msk))                     # [n,64]
    k = cp.shape[0]
    kc = 8
    pad = (-k) % kc
    cpj = jnp.asarray(np.pad(cp, ((0, pad), (0, 0), (0, 0))))

    @jax.jit
    def matrix(cpj, tl, tm):
        def chunk(i):
            c = jax.lax.dynamic_slice_in_dim(cpj, i * kc, kc)
            d = ((tl[None, :, :, None, :] - c[:, None, None, :, :]) ** 2
                 ).sum(-1).min(-1)                         # [kc,n,64px]
            return ((d > gate) & tm[None]).sum(-1) <= 3
        return jax.lax.map(chunk, jnp.arange((k + pad) // kc))

    return np.asarray(matrix(cpj, tl, tm)).reshape(-1, len(clouds))[:k]


def mine_bank2d(images, out_dir, max_tables=12, max_candidates=256,
                engine="host"):
    """images -> Bank2D pattern PNGs loadable by encoder.bank2d (and by the
    reference's Load2DPattern). Greedy max-coverage like the 3D miner."""
    from yaik_tpu.utils import png
    clouds = []
    for im in images:
        clouds.extend(capture_clouds_2d(np.asarray(im)))
    if not clouds:
        return 0, 0
    step = max(1, len(clouds) // max_candidates)
    cands = [clouds[i] for i in range(0, len(clouds), step)]
    if engine == "device":
        cover = _covers2d_device(cands, clouds)
    else:
        cover = np.stack([_covers_2d(c, clouds) for c in cands])
    covered = np.zeros(len(clouds), bool)
    picked = []
    for _ in range(max_tables):
        gains = (cover & ~covered[None, :]).sum(axis=1)
        best = int(gains.argmax())
        if gains[best] == 0:
            break
        picked.append(cands[best])
        covered |= cover[best]
    os.makedirs(out_dir, exist_ok=True)
    for k, pts in enumerate(picked):
        img = np.zeros((64, 64, 3), np.uint8)
        img[pts[:, 1], pts[:, 0]] = 255
        png.write_png(
            os.path.join(out_dir, f"t{k + 1}_tileMap{2000 + k}.lut.png"), img)
    return len(picked), len(clouds)
