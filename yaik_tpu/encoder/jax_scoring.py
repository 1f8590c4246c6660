"""Device-side encoder scoring: every candidate tile x variant / LUT x
pattern scored in parallel (the SURVEY section-7 design: "score everything,
then a cheap deterministic greedy claim").

Bit-exact JAX ports of the host passes in gradient.py / corr3d.py:

- gradient_pass_device: the 6-variant bilinear accept test for every tile
  position of one size (integer math, exact).
- tile3d_pass_device: for every tile of one size, against every LUT:
  * 48-pattern scoring. Instead of the reference's 64^3 distance field we
    transform the 8 scoring points into each pattern's inverse frame and
    take min-squared-distance directly - identical values by construction
    (the field stores min over the same 8 points, Set3DPointCloud :4778+),
    including the cumulative-mutation pattern quirk (PERMS48).
  * computeValues3D: per-bit-depth nearest-point indices (first-min ties =
    argmin), exact float32 normalization and integer reconstruction,
    wrong-pixel rejection, fewest-bits mode choice.
  * LUT selection scan (diff <= running best -> later LUT wins ties).

Tiles are processed in fixed-size chunks via lax.map to bound device-memory
transients. Claims evolve on device between passes; only stream EMISSION
(corner dedup, cursor order, entropy coding) stays on host, driven by the
downloaded accept/choice tensors.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from yaik_tpu.encoder.corr3d import PERMS48, SWAP3D
from yaik_tpu.encoder.gradient import WEIGHTS, ROUNDING
from yaik_tpu.ops.score48 import score48

FACTOR = 128
SKIP = 4


def round6(v):
    r = v >> 2
    return (r << 2) | (r >> 4)


def round6p(v):
    v = jnp.minimum(v + 1, 255)
    r = v >> 2
    return (r << 2) | (r >> 4)


# ---------------------------------------------------------------------------
# Gradient scoring
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("sx", "sy", "reject_factor"))
def gradient_pass_device(planes, claims, sx, sy, reject_factor):
    """planes: [3,H,W] i32; claims: [3,H,W] bool. Returns accept [nty,ntx]
    and updated claims. Exact port of gradient.score_pass + claim update."""
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape
    ntx, nty = w // tw, h // th

    # exactly nty+1 / ntx+1 corner positions: for exact-multiple shapes
    # this equals arange(0, w + tw, tw); for a banded slice carrying a
    # +1-row halo (encode_image_banded) it keeps the corner grid sized to
    # the tile grid while the last row's bottom corners read the halo row
    xs = jnp.minimum(jnp.arange(0, (ntx + 1) * tw, tw), w - 1)
    ys = jnp.minimum(jnp.arange(0, (nty + 1) * th, th), h - 1)
    # int32 is sufficient: blends peak at 255*1024*1024 + 2^19 < 2^31
    corners = planes[:, ys[:, None], xs[None, :]].astype(jnp.int32)

    c00 = corners[:, :nty, :ntx]
    c01 = corners[:, :nty, 1:]
    c10 = corners[:, 1:, :ntx]
    c11 = corners[:, 1:, 1:]

    pix = planes[:, :nty * th, :ntx * tw].reshape(3, nty, th, ntx, tw)
    pix = pix.transpose(0, 1, 3, 2, 4).astype(jnp.int32)

    lf = jnp.asarray(WEIGHTS[tw], jnp.int32).reshape(1, 1, 1, 1, tw)
    rf = 1024 - lf
    tf = jnp.asarray(WEIGHTS[th], jnp.int32).reshape(1, 1, 1, th, 1)
    bf = 1024 - tf

    def blends(a, b, c, d):
        top = a[:, :, :, None, None] * lf + b[:, :, :, None, None] * rf
        bot = c[:, :, :, None, None] * lf + d[:, :, :, None, None] * rf
        num = top * tf + bot * bf
        # num is non-negative: / (1024*1024) == >> 20 (and shifts compile
        # orders of magnitude faster than integer division on this backend)
        return ((num + ROUNDING) >> 20, num >> 20)

    ok = jnp.zeros((nty, ntx), bool)
    for variant in (blends(c00, c01, c10, c11),
                    blends(round6(c00), round6(c01), round6(c10), round6(c11)),
                    blends(round6p(c00), round6p(c01),
                           round6p(c10), round6p(c11))):
        for bl in variant:
            ok |= (jnp.abs(pix - bl) <= reject_factor).all(axis=(0, 3, 4))

    origins = claims[:, ::th, ::tw][:, :nty, :ntx]
    accept = ok & ~origins.any(axis=0)

    up = jnp.repeat(jnp.repeat(accept, th, 0), tw, 1)
    region = claims[:, :nty * th, :ntx * tw] | up[None]
    claims = claims.at[:, :nty * th, :ntx * tw].set(region)
    return accept, claims


@partial(jax.jit, static_argnames=("reject_factor",))
def gradient_all_device(planes, claims, reject_factor):
    """All 7 gradient passes in ONE dispatch (claims evolve in-graph).
    Returns (accepts tuple, final claims)."""
    accepts = []
    for (sx, sy) in [(4, 4), (4, 3), (3, 4), (3, 3), (3, 2), (2, 3), (2, 2)]:
        acc, claims = gradient_pass_device.__wrapped__(
            planes, claims, sx, sy, reject_factor)
        accepts.append(acc)
    return tuple(accepts), claims


# ---------------------------------------------------------------------------
# 3D-LUT pass
# ---------------------------------------------------------------------------

def transformed_points(points3bit: np.ndarray) -> np.ndarray:
    """Host precompute: the 8 scoring points of each LUT mapped into each of
    the 48 patterns' inverse frames: dist_field_e[T_n(c)] ==
    min_k ||c - Q[e,n,k]||^2 with T_n: c' = flip_n(perm_n(c)), so
    Q = perm_n^{-1}(flip_n applied on the post-perm axes... equivalently
    Q[ax] = flip-if-bit(perm-position-of-ax)(p[ax']) - derived below."""
    E = points3bit.shape[0]
    q = np.zeros((E, 48, 8, 3), np.int32)
    for n in range(48):
        p = PERMS48[n]
        # c' = perm(c): c'[i] = c[p[i]]; then flips on c'[i] by bit i.
        # ||flip_i(c[p[i]]) - pt[i]||^2 = ||c[p[i]] - flip_i(pt[i])||^2
        # so Q[p[i]] = flip_i(pt[i]).
        pts = points3bit.astype(np.int32)
        for i in range(3):
            v = pts[:, :, i]
            if n & (1 << i):
                v = 63 - v
            q[:, n, :, p[i]] = v
    return q


# ---------------------------------------------------------------------------
# Resident 3D pass: the float32 normalizations run on device as exact
# integer/float twins of the host x86 chains (_norm_coords); everything
# else device-side is integer -> backend-exact.
# ---------------------------------------------------------------------------

# pixels per chunk of the lax.map that bounds the values stage's (and, on
# the plain path, the scoring's) transients. One H100 (700 W), 8 images of
# 512^2 (tools/ab_score48.py): 49152 runs the bundle in 19.88 ms min,
# 98304 in 20.32 ms with 36% more temporaries
VALUES_CHUNK_PX = 49152


def _kernel_scoring() -> bool:
    """The GPU scores with ops.score48 (the Triton route compiles only
    there); other backends run the plain form. tools/ab_score48.py
    replaces this to time the two forms on one card."""
    return jax.default_backend() == "gpu"


@partial(jax.jit, static_argnames=())
def tile3d_score_device(c, alive, qpts):
    """Pattern scores. c: [T,P,3] i32 normalized coords; alive: [T,P] bool;
    qpts: [E,48,8,3] i32. Returns sums [T,E,48] i32.

    The plain XLA form, elementwise: XLA fuses the [T,P,E,48,8,3]
    transient straight into the min/sum reductions so it never touches
    device memory. It is the reference for ops.score48, the GPU's
    kernel."""
    diff = (c[:, :, None, None, None, :]
            - qpts[None, None, :, :, :, :])                # T,P,E,48,8,3
    dist = (diff * diff).sum(-1).min(-1)                   # T,P,E,48
    return jnp.where(alive[:, :, None, None], dist, 0).sum(axis=1)


def _norm_coords(k, d):
    """Per-channel tile normalizations on device. k [N, P] i32 = pixel -
    tile min (0..d), d [N] i32 = tile range. Returns (cc, ac, bc) [N, P]
    i32, each equal to the host float32 chain it replaces:

    - cc, the scoring coords (corr3d :6345-6400): int(f32(k * (2^20 // d))
      / 2^20 * 63). int->f32 conversion and f32 multiply are correctly
      rounded and dividing by 2^20 is exact, so the chain is the same ops;
    - ac, bc, the computeValues coords: trunc(RN(RN(k/d))*63) == (k*63)//d
      and trunc(63 - RN(RN(k/d))*63) == 63 - q - (r != 0) for all
      k <= d <= 255 (the double-rounding error, <= ~7.5e-6, cannot cross
      a 1/d >= 1/255 boundary). The floor division is an exact magic
      multiply: q = (n*M) >> 22 == n//d for n = 63k, k <= d <= 255, since
      n*e <= 63*d^2 < 2^22 (Granlund-Montgomery).

    chip_smoke.py's exactness phase checks all three against numpy on the
    host for every k <= d <= 255."""
    nvec = jnp.where(d > 0, (1 << 20) // jnp.maximum(d, 1), 0)
    r = k * nvec[:, None]
    cc = ((r.astype(jnp.float32) / jnp.float32(1 << 20))
          * jnp.float32(63)).astype(jnp.int32)
    k63 = k * 63
    dd = jnp.maximum(d, 1)[:, None]
    magic = (1 << 22) // jnp.maximum(d, 1) + 1               # [N] only
    q0 = (k63 * magic[:, None]) >> 22
    q = jnp.where(d[:, None] > 0, q0, k63)
    rem = jnp.where(d[:, None] > 0, k63 - q0 * dd, 0)
    return cc, q, 63 - q - (rem != 0).astype(jnp.int32)


@partial(jax.jit, static_argnames=("sx", "sy"))
def tile3d_pass_resident(planes, claims, qpts, pts_sub, factors, sx, sy):
    """Single-image wrapper over the natively-batched resident pass
    (always dense - it is the fallback when compaction caps overflow)."""
    accept, typ, idx, mask, mn, mx, claims_b, _ = tile3d_pass_resident_b(
        planes[None], claims[None], qpts, pts_sub, factors, sx, sy)
    return (accept[0], typ[0], idx[0], mask[0], mn[0], mx[0], claims_b[0])


@partial(jax.jit, static_argnames=("sx", "sy", "cap_score"))
def tile3d_pass_resident_b(planes_b, claims_b, qpts, pts_sub, factors,
                           sx, sy, cap_score=None):
    """One fully device-resident 3D size pass over a BATCH of images
    [B,3,H,W]: tiles/masks/bboxes and the normalizations all on device,
    claims updated in-graph. Images are independent, so the batch is
    flattened into the tile axis (B*T) - this keeps the scoring kernel
    out of vmap and feeds it bigger grids.

    Exactness: the normalizations are _norm_coords (each chain checked
    against the host for every k <= d <= 255); the scoring is integer,
    whether by ops.score48 or the plain form.

    Returns (accept [B,T] bool, tile_type [B,T] i32, idx [B,T,P] i32,
             mask [B,T,P] bool, mn/mx [B,T,3], claims)."""
    tw, th = 1 << sx, 1 << sy
    B, _, h, w = planes_b.shape
    ntx, nty = w // tw, h // th
    T, P = nty * ntx, th * tw
    N = B * T

    # channel-UNROLLED tensors throughout: per-channel [N, P] twins keep
    # P (or th*tw) minor instead of materializing [N, P, 3] layouts
    tb6 = planes_b[:, :, :nty * th, :ntx * tw].reshape(
        B, 3, nty, th, ntx, tw)
    tiles_c = tuple(
        tb6[:, c].transpose(0, 1, 3, 2, 4).reshape(N, P).astype(jnp.int32)
        for c in range(3))
    cm = claims_b.all(axis=1)[:, :nty * th, :ntx * tw]
    mask = cm.reshape(B, nty, th, ntx, tw).transpose(0, 1, 3, 2, 4).reshape(
        N, P)
    alive = ~mask

    cnt = alive.sum(axis=1)
    mn_c = tuple(jnp.min(jnp.where(alive, t, 999), axis=1)
                 for t in tiles_c)                              # 3x [N]
    mx_c = tuple(jnp.max(jnp.where(alive, t, -999), axis=1)
                 for t in tiles_c)
    d_c = tuple(mx - mn for mx, mn in zip(mx_c, mn_c))
    pre = (cnt > 0) & (sum((dc == 0).astype(jnp.int32)
                           for dc in d_c) <= 1)

    # Optional alive-tile compaction (cap_score static): after the gradient
    # stage claims pixels, only a small fraction of tiles still carry alive
    # pixels (~10% on gradient-heavy art at every size, counted) - scoring
    # only the first cap alive tiles per image cuts the dominant encoder
    # device cost ~T/cap x. A tile beyond the cap would be silently
    # unscored, so alive_cnt travels to the host, which falls back to the
    # dense single-image path for any image with alive_cnt > cap (same
    # contract as the download caps). Dense when cap_score is None.
    alive_cnt = jnp.zeros((B,), jnp.int32)
    if cap_score is not None:
        C = int(cap_score)
        aany = alive.any(axis=1).reshape(B, T)
        csum = jnp.cumsum(aany.astype(jnp.int32), axis=1)      # [B,T]
        alive_cnt = csum[:, -1]
        targets = jnp.arange(C, dtype=jnp.int32) + 1
        pos = jax.vmap(lambda cs: jnp.searchsorted(cs, targets))(csum)
        srcv = jnp.minimum(pos, T - 1)                          # [B,C]
        valid = (targets[None, :] <= alive_cnt[:, None]).reshape(-1)
        flat_src = (jnp.arange(B, dtype=jnp.int32)[:, None] * T
                    + srcv).reshape(-1)                         # [B*C]

        def take(x):
            return jnp.take(x, flat_src, axis=0)
        tiles_cs = tuple(take(t) for t in tiles_c)
        alive_s = take(alive) & valid[:, None]
        mn_cs = tuple(take(m) for m in mn_c)
        d_cs = tuple(take(dc) for dc in d_c)
        pre_s = take(pre) & valid
        Ns = B * C
    else:
        tiles_cs, alive_s = tiles_c, alive
        mn_cs, d_cs, pre_s = mn_c, d_c, pre
        Ns = N

    k_c = tuple(t - m[:, None] for t, m in zip(tiles_cs, mn_cs))
    cc, ac_c, bc_c = zip(*(_norm_coords(k, dc) for k, dc in zip(k_c, d_cs)))

    tc = max(1, VALUES_CHUNK_PX // P)
    pad = (-Ns) % tc
    nch = (Ns + pad) // tc

    def chunk(v, i):
        v = jnp.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1))
        return jax.lax.dynamic_slice_in_dim(v, i * tc, tc)

    if _kernel_scoring():
        # the whole batch's scoring in one Triton-route kernel, then the
        # values stage in chunks
        sums = score48(jnp.stack(cc, axis=-1), alive_s, qpts)  # [Ns,E,48]
        mode48 = jnp.argmin(sums, axis=-1).astype(jnp.int32)  # [Ns,E]
        stacked = jax.lax.map(
            lambda i: _values_core(
                tuple(chunk(v, i) for v in tiles_cs), chunk(alive_s, i),
                tuple(chunk(v, i) for v in ac_c),
                tuple(chunk(v, i) for v in bc_c), chunk(mode48, i),
                tuple(chunk(v, i) for v in mn_cs),
                tuple(chunk(v, i) for v in d_cs), pts_sub, factors),
            jnp.arange(nch))
    else:
        # the plain form, scoring and values per chunk
        stacked = jax.lax.map(
            lambda i: tile3d_pass_hybrid.__wrapped__(
                *(chunk(v, i)
                  for v in (jnp.stack(tiles_cs, -1), alive_s,
                            jnp.stack(cc, -1), jnp.stack(ac_c, -1),
                            jnp.stack(bc_c, -1), jnp.stack(mn_cs, -1),
                            jnp.stack(d_cs, -1))),
                qpts, pts_sub, factors),
            jnp.arange(nch))
    acc = stacked[0].reshape(-1)[:Ns]
    typ = stacked[1].reshape(-1)[:Ns]
    idx = stacked[2].reshape(-1, P)[:Ns]

    if cap_score is not None:
        accept_c = acc & pre_s
        scat = jnp.where(valid, flat_src, N)       # N == out of range
        accept = jnp.zeros((N,), bool).at[scat].set(accept_c, mode="drop")
        typ = jnp.zeros((N,), jnp.int32).at[scat].set(typ, mode="drop")
        idx = jnp.zeros((N, P), jnp.int32).at[scat].set(idx, mode="drop")
    else:
        accept = acc & pre

    up = jnp.repeat(jnp.repeat(accept.reshape(B, nty, ntx), th, 1), tw, 2)
    region = claims_b[:, :, :nty * th, :ntx * tw] | up[:, None]
    claims_b = claims_b.at[:, :, :nty * th, :ntx * tw].set(region)
    mn3 = jnp.stack(mn_c, axis=-1)
    mx3 = jnp.stack(mx_c, axis=-1)
    return (accept.reshape(B, T), typ.reshape(B, T), idx.reshape(B, T, P),
            mask.reshape(B, T, P), mn3.reshape(B, T, 3),
            mx3.reshape(B, T, 3), claims_b, alive_cnt)


@partial(jax.jit, static_argnames=())
def tile3d_pass_hybrid(tiles, alive, c, a_c, b_c, mn, d, qpts, pts_sub,
                       factors):
    """Full 3D pass given host-normalized coords: one device dispatch.

    mode48 selection note: GetEvaluation3D argmins f32 sums/(cnt*1024).
    sums are exact ints < 2^21 and the divisor is shared per tile, so
    correctly-rounded division is strictly monotonic here (relative gaps
    >= 2^-21 > f32 ulp 2^-23 -> no rounding collisions) - argmin over the
    INTEGER sums is exactly the reference's choice, with no division at all.
    """
    tiles = tiles.astype(jnp.int32)
    c = c.astype(jnp.int32)
    a_c, b_c = a_c.astype(jnp.int32), b_c.astype(jnp.int32)
    mn, d = mn.astype(jnp.int32), d.astype(jnp.int32)
    sums = tile3d_score_device.__wrapped__(c, alive, qpts)   # [T,E,48]
    mode48 = jnp.argmin(sums, axis=-1).astype(jnp.int32)     # [T,E]
    return tile3d_values_device.__wrapped__(
        tiles, alive, a_c, b_c, mode48, mn, d, pts_sub, factors)


@partial(jax.jit, static_argnames=())
def tile3d_values_device(tiles, alive, a_c, b_c, mode48, mn, d, pts_sub,
                         factors):
    """computeValues3D for all (tile, LUT): integer only.

    tiles [T,P,3] i32; alive [T,P]; a_c/b_c [T,P,3] i32 (host-truncated
    normalizations); mode48 [T,E]; mn,d [T,3]; pts_sub [E,64,3];
    factors [4,E,64,3]. Returns (accept [T], tile_type [T],
    idx_sel [T,P]). Thin channel-splitting wrapper over _values_core
    (callers that already hold per-channel arrays call the core)."""
    return _values_core(
        tuple(tiles[:, :, i] for i in range(3)), alive,
        tuple(a_c[:, :, i] for i in range(3)),
        tuple(b_c[:, :, i] for i in range(3)), mode48,
        tuple(mn[:, i] for i in range(3)),
        tuple(d[:, i] for i in range(3)), pts_sub, factors)


def _values_core(tiles_c, alive, ac_c, bc_c, mode48, mn_c, d_c, pts_sub,
                 factors):
    """Channel-unrolled computeValues3D core: every operand is a tuple of
    3 per-channel [T,P] / [T] arrays so no minor-3 tensor ever
    materializes."""
    T, P = tiles_c[0].shape
    E = mode48.shape[1]
    # Layout rule: every large tensor keeps the pixel axis P or the point
    # axis n minor, never the 3-channel axis. Channels are unrolled in
    # Python into triples of [T,E,P] arrays; the four bit-depth point sets
    # are packed into one 120-wide axis.
    M = E * P          # flattened (LUT, pixel) axis: every large
    # intermediate keeps M (192+ for P=16) minor instead of P alone
    flip = [((mode48 >> i) & 1) for i in range(3)]                # 3x [T,E]
    # permutation as 0/1 coefficients instead of a per-pixel gather:
    # pm[t,e,o,s] = 1 iff perm[o] == s
    pm6 = jnp.asarray(np.eye(3, dtype=np.float32)[
        np.asarray([SWAP3D[s] for s in range(6)])])               # 6,3(o),3(s)
    pmat = pm6[mode48 >> 3]                                       # T,E,3,3
    m_s = [jnp.where(flip[i][:, :, None] == 1,
                     bc_c[i][:, None, :], ac_c[i][:, None, :])
           .astype(jnp.float32) for i in range(3)]                # 3x [T,E,P]
    mf = [sum(pmat[:, :, o, s][:, :, None] * m_s[s] for s in range(3))
          .reshape(T, M) for o in range(3)]                       # 3x [T,M]

    # one packed point axis: [64 | 32 | 16 | 8] = 120 points for all four
    # bit depths; per-depth windows are static slices
    steps = ((1, 64), (2, 32), (4, 16), (8, 8))
    sf = jnp.concatenate([pts_sub[:, ::st][:, :n] for st, n in steps],
                         axis=1).astype(jnp.float32)              # [E,120,3]
    sfb = [jnp.broadcast_to(sf[:, None, :, s], (E, P, 120))
           .reshape(M, 120) for s in range(3)]                    # 3x [M,120]
    # |m-s|^2 is computed PER WINDOW inside the loop below (window = a
    # static slice of the packed 120-point axis): with one variadic
    # reduce as each window's sole consumer the distance tensor fuses
    # into the reduce and never materializes, where a shared [T,M,120]
    # dist sliced by four windows would. Exact: same per-element op order
    # either way.

    pmat_m = [[jnp.broadcast_to(pmat[:, :, o, s][:, :, None], (T, E, P))
               .reshape(T, M) for s in range(3)] for o in range(3)]
    mn_m = [jnp.broadcast_to(mn_c[o][:, None, None], (T, E, P))
            .reshape(T, M) for o in range(3)]
    d_m = [jnp.broadcast_to(d_c[o][:, None, None], (T, E, P))
           .reshape(T, M) for o in range(3)]
    tl_m = [jnp.broadcast_to(tiles_c[o][:, None, :], (T, E, P))
            .reshape(T, M) for o in range(3)]
    alive_m = jnp.broadcast_to(alive[:, None, :], (T, E, P)
                               ).reshape(T, M)

    acc_mode = jnp.full((T, E), SKIP, jnp.int32)
    diff_sel = jnp.zeros((T, E), jnp.int32)
    idx_by_bit = []
    sgn = [jnp.where(flip[s] == 1, -1.0, 1.0)[:, :, None] for s in range(3)]
    base = [(flip[s].astype(jnp.float32)
             * jnp.float32(FACTOR))[:, :, None] for s in range(3)]
    sgn_m = [jnp.broadcast_to(sgn[s], (T, E, P)).reshape(T, M)
             for s in range(3)]
    base_m = [jnp.broadcast_to(base[s], (T, E, P)).reshape(T, M)
              for s in range(3)]
    off = 0
    for bi, (step, npts) in enumerate(steps):
        db = sum((mf[s][:, :, None] - sfb[s][None, :, off:off + npts]) ** 2
                 for s in range(3))                               # T,M,n
        off += npts
        iot = jnp.arange(npts, dtype=jnp.int32)
        ff = factors[3 - bi][:, :npts].astype(jnp.float32)        # E,n,3
        # factor channels ride the reduce as two packed payload fields:
        # f0*4096 + f1 is f32-exact for factors <= 4095 (real banks have
        # f <= 128 - bank.py trunc(v/63*128); a 3-in-1 *65536 packing
        # was exact only to 128 and silently corrupted larger factors)
        ffpA = ff[..., 0] * 4096.0 + ff[..., 1]
        ffpB = ff[..., 2]

        def bcast(x):
            return jnp.broadcast_to(
                x[:, None, :], (E, P, npts)).reshape(M, npts)[None]

        # ONE variadic argmin-with-payload reduce replaces the
        # dmin-reduce + tie-min-iota reduce + masked-min factor gather
        # (three full passes over the distance tensor). The combiner's
        # (value, then smaller index) order reproduces the first-min tie
        # rule exactly; the winner's packed factors ride along.

        def red(a, b):
            av, ai, afa, afb = a
            bv, bi_, bfa, bfb = b
            tb = (bv < av) | ((bv == av) & (bi_ < ai))
            return (jnp.where(tb, bv, av), jnp.where(tb, bi_, ai),
                    jnp.where(tb, bfa, afa), jnp.where(tb, bfb, afb))

        _, idx, fAf, fBf = jax.lax.reduce(
            (db, jnp.broadcast_to(iot[None, None, :], db.shape),
             jnp.broadcast_to(bcast(ffpA), db.shape),
             jnp.broadcast_to(bcast(ffpB), db.shape)),
            (jnp.float32(np.inf), jnp.int32(npts), jnp.float32(0),
             jnp.float32(0)),
            red, (2,))                                            # [T,M]
        idx_by_bit.append(idx)
        fA = fAf.astype(jnp.int32)
        fsel = [(fA >> 12).astype(jnp.float32),
                (fA & 0xFFF).astype(jnp.float32), fBf]
        fxs = [base_m[s] + sgn_m[s] * fsel[s] for s in range(3)]  # [T,M]
        ld = jnp.zeros((T, M), jnp.int32)
        for o in range(3):
            fx_o = sum(pmat_m[o][s] * fxs[s]
                       for s in range(3)).astype(jnp.int32)
            recon = mn_m[o] + ((fx_o * d_m[o]) >> 7)
            ld = jnp.maximum(ld, jnp.abs(recon - tl_m[o]))
        ldiff = jnp.where(alive_m, ld, 0).reshape(T, E, P)
        ok = (ldiff > 5).sum(-1) <= 3
        acc_mode = jnp.where(ok, jnp.int32(3 - bi), acc_mode)
        diff_sel = jnp.where(ok, ldiff.sum(-1), diff_sel)

    # LUT selection scan: e in order, accept if mode != SKIP and
    # diff <= running best (later LUT wins ties) - integer, exact
    INIT = jnp.int32(1215752191)          # (int)99999999999, :6459
    best_diff = jnp.full((T,), INIT, jnp.int32)
    best_e = jnp.full((T,), -1, jnp.int32)
    for e in range(E):
        okE = (acc_mode[:, e] != SKIP) & (diff_sel[:, e] <= best_diff)
        best_diff = jnp.where(okE, diff_sel[:, e], best_diff)
        best_e = jnp.where(okE, e, best_e)
    accept = best_e >= 0
    e_sel = jnp.maximum(best_e, 0)
    # one-hot selects instead of fancy-index gathers: the masked sums are
    # plain vector ops and exact (integers, exactly one term per row)
    onehot_e = (jnp.arange(E, dtype=jnp.int32)[None, :]
                == e_sel[:, None]).astype(jnp.int32)       # [T,E]
    mode_sel = (mode48 * onehot_e).sum(axis=1)
    acc_sel = (acc_mode * onehot_e).sum(axis=1)
    bitmode = jnp.minimum(acc_sel, 3)
    tile_type = mode_sel | (e_sel << 6) | (bitmode << 14)
    sel_bi = 3 - bitmode                                   # [T] in 0..3
    idx_m = idx_by_bit[0]
    for bi in range(1, 4):
        idx_m = jnp.where((sel_bi == bi)[:, None], idx_by_bit[bi], idx_m)
    idx_sel = (idx_m.reshape(T, E, P)
               * onehot_e[:, :, None]).sum(axis=1)         # [T,P]
    return accept, tile_type, idx_sel


def _pass_chunk(sx, sy, E, P, chunk):
    """Build the per-chunk tile computation (closure for lax.map)."""

    def body(args):
        tiles, mask, qpts, pts_sub, factors = args
        # tiles [Tc,P,3] i32, mask [Tc,P] bool(skip)
        alive = ~mask
        cnt = alive.sum(axis=1)
        mn = jnp.min(jnp.where(alive[:, :, None], tiles, 999), axis=1)
        mx = jnp.max(jnp.where(alive[:, :, None], tiles, -999), axis=1)
        d = mx - mn
        nflat = (d == 0).sum(axis=1)
        pre = (cnt > 0) & (nflat <= 1)

        nvec = jnp.where(d > 0, (1 << 20) // jnp.maximum(d, 1), 0)
        r = (tiles - mn[:, None, :]) * nvec[:, None, :]
        fr = r.astype(jnp.float32) / jnp.float32(1 << 20)
        c = (fr * jnp.float32(63)).astype(jnp.int32)          # [Tc,P,3]

        # all 48 patterns at once; XLA fuses the [Tc,P,E,48,8] transient
        # into the min/sum reductions
        diff = (c[:, :, None, None, None, :]
                - qpts[None, None, :, :, :, :])                # Tc,P,E,48,8,3
        dist = (diff * diff).sum(-1).min(-1)                   # Tc,P,E,48
        sums = jnp.where(alive[:, :, None, None], dist, 0).sum(axis=1)
        avg = sums.astype(jnp.float32) / (
            cnt[:, None, None].astype(jnp.float32) * jnp.float32(1024.0))
        mode48 = jnp.argmin(avg, axis=-1).astype(jnp.int32)    # [Tc,E]

        rel = (tiles - mn[:, None, :]).astype(jnp.float32)
        dd = jnp.maximum(d, 1).astype(jnp.float32)
        rel = jnp.where(d[:, None, :] > 0, rel / dd[:, None, :], rel)
        rel = rel * jnp.float32(63)
        a_c = rel.astype(jnp.int32)
        b_c = (jnp.float32(63) - rel).astype(jnp.int32)

        flip = jnp.stack([(mode48 >> i) & 1 for i in range(3)], -1)
        m = jnp.where(flip[:, :, None, :] == 1,
                      b_c[:, None, :, :], a_c[:, None, :, :])  # Tc,E,P,3
        perms = jnp.asarray([SWAP3D[s] for s in range(6)], jnp.int32)
        perm_te = perms[mode48 >> 3]                           # [Tc,E,3]
        m = jnp.take_along_axis(m, perm_te[:, :, None, :], axis=3)

        Tc = tiles.shape[0]
        acc_mode = jnp.full((Tc, E), SKIP, jnp.int32)
        diff_sel = jnp.zeros((Tc, E), jnp.int32)
        idx_by_bit = []
        for bi, (step, npts) in enumerate(((1, 64), (2, 32), (4, 16), (8, 8))):
            sub = pts_sub[:, ::step][:, :npts]                 # [E,n,3]
            dif = m[:, :, :, None, :] - sub[None, :, None, :, :]
            dist = (dif * dif).sum(-1)                         # Tc,E,P,n
            idx = jnp.argmin(dist, axis=-1).astype(jnp.int32)  # Tc,E,P
            idx_by_bit.append(idx)
            f = factors[3 - bi]                                # [E,64,3]
            fsel = f[jnp.arange(E)[None, :, None], idx]        # Tc,E,P,3
            fx = jnp.where(flip[:, :, None, :] == 1, FACTOR - fsel, fsel)
            fx = jnp.take_along_axis(fx, perm_te[:, :, None, :], axis=3)
            # fx, d >= 0: // FACTOR(=128) == >> 7
            recon = mn[:, None, None, :] + ((fx * d[:, None, None, :]) >> 7)
            ldiff = jnp.abs(recon - tiles[:, None, :, :]).max(-1)
            ldiff = jnp.where(alive[:, None, :], ldiff, 0)
            ok = (ldiff > 5).sum(-1) <= 3
            acc_mode = jnp.where(ok, jnp.int32(3 - bi), acc_mode)
            diff_sel = jnp.where(ok, ldiff.sum(-1), diff_sel)

        INIT = jnp.int32(1215752191)      # (int)99999999999, :6459
        best_diff = jnp.full((Tc,), INIT, jnp.int32)
        best_e = jnp.full((Tc,), -1, jnp.int32)
        for e in range(E):
            okE = (acc_mode[:, e] != SKIP) & (diff_sel[:, e] <= best_diff)
            best_diff = jnp.where(okE, diff_sel[:, e], best_diff)
            best_e = jnp.where(okE, e, best_e)

        accept = pre & (best_e >= 0)
        e_sel = jnp.maximum(best_e, 0)
        rows = jnp.arange(Tc)
        mode_sel = mode48[rows, e_sel]
        bitmode = jnp.minimum(acc_mode[rows, e_sel], 3)
        tile_type = mode_sel | (e_sel << 6) | (bitmode << 14)
        bbox = jnp.concatenate([mn, mx], axis=1)

        idx_stack = jnp.stack(idx_by_bit, axis=0)              # [4,Tc,E,P]
        idx_sel = idx_stack[(3 - bitmode)[:, None], rows[:, None],
                            e_sel[:, None], jnp.arange(P)[None, :]]
        return accept, tile_type, bbox, idx_sel

    return body


@partial(jax.jit, static_argnames=("sx", "sy"))
def tile3d_pass_device(planes, claims, qpts, pts_sub, factors, sx, sy):
    """One Correlation3DSearch size pass, fully on device. Returns
    (accept [T], tile_type [T], bbox [T,6], idx_dense [T,P], mask [T,P],
    updated claims)."""
    tw, th = 1 << sx, 1 << sy
    _, h, w = planes.shape
    ntx, nty = w // tw, h // th
    T, P = nty * ntx, th * tw
    E = qpts.shape[0]

    tiles = planes[:, :nty * th, :ntx * tw].reshape(3, nty, th, ntx, tw)
    tiles = tiles.transpose(1, 3, 2, 4, 0).reshape(T, P, 3)
    cmask = claims.all(axis=0)[:nty * th, :ntx * tw]
    cmask = cmask.reshape(nty, th, ntx, tw).transpose(0, 2, 1, 3)
    mask = cmask.reshape(T, P)

    chunk = max(1, 4096 // P)
    pad = (-T) % chunk
    tiles_p = jnp.pad(tiles, ((0, pad), (0, 0), (0, 0)))
    mask_p = jnp.pad(mask, ((0, pad), (0, 0)), constant_values=True)
    nchunks = (T + pad) // chunk

    body = _pass_chunk(sx, sy, E, P, chunk)
    accept, tile_type, bbox, idx_sel = jax.lax.map(
        lambda i: body((jax.lax.dynamic_slice_in_dim(tiles_p, i * chunk, chunk),
                        jax.lax.dynamic_slice_in_dim(mask_p, i * chunk, chunk),
                        qpts, pts_sub, factors)),
        jnp.arange(nchunks))
    accept = accept.reshape(-1)[:T]
    tile_type = tile_type.reshape(-1)[:T]
    bbox = bbox.reshape(-1, 6)[:T]
    idx_sel = idx_sel.reshape(-1, P)[:T]

    up = jnp.repeat(jnp.repeat(accept.reshape(nty, ntx), th, 0), tw, 1)
    region = claims[:, :nty * th, :ntx * tw] | up[None]
    claims = claims.at[:, :nty * th, :ntx * tw].set(region)
    return accept, tile_type, bbox, idx_sel, mask, claims
