"""Device decode engine: dense pixel passes in plain JAX/XLA.

Consumes the dense per-tile tensors from yaik_tpu.decoder.planner and runs
all pixel math on device:

  - gradient passes: exact YAIK_Gradient.cpp bilinears as constant
    matmuls (By @ cg @ Bx, bf16-exact operands), masked by accept grids
  - 3D-LUT and 2D-LUT tiles: per-pixel LUT entries by an integer gather
    from each tile's packed table row, then the min/diff color apply and
    the write bit
  - 1D residual: tile-space values, one relayout, bitwise masked blend
  - image assembly: reshapes of full tile grids (no scatter)

Layout: all pixel state lives in ONE channel-packed u32 word per pixel
(r | g<<8 | b<<16, alpha joining bits 24-31 at the end) - [h, w]. Each
pass applies as a single bitwise masked blend
    plane ^= (plane ^ vals) & mask32
where mask32 carries 0xFF per written channel byte - plane-subset writes
(GTIL plane != 7, 2DTL pairs, per-channel 1D residuals) are just masks.
The reference keeps swizzled PLANAR buffers instead (YAIK.h:205-224).

The same function compiles for the CPU tests and the GPU, and batches
with vmap.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from yaik_tpu.decoder import planner as plannermod
from yaik_tpu.format import lut as lutmod
from yaik_tpu.format import swizzle

GRAD_SHIFTS = tuple(swizzle.GRADIENT_PASS_ORDER)
T3_SHIFTS = tuple(swizzle.TILE3D_PASS_ORDER)
# merged Tile3D: all 6 size passes re-blocked onto the uniform 4x4 grid as
# <= 2 priority layers (see t3_merge_plan) - each layer decodes as one
# (2, 2) pass, so the T3 stage costs 2 resolves + 2 tile->image relayouts
# instead of 6
MERGED_T3_SHIFTS = ((2, 2), (2, 2))
# position of the packed 1D params (d1_prm) in plan_to_device_args' per-image
# args: the bench chains salt it between steps (salt_d1_color0)
D1_PRM_ARG = 6


def _blend_mats(nty, ntx, qh, qw, sx, sy):
    """Constant blend matrices for one gradient pass: vals = (By @ cg @ Bx)
    >> (sy+sx) reproduces the exact YAIK_Gradient.cpp bilinear. By[y, :]
    carries (th-ry) at the tile's top corner row and ry at the bottom
    (corner grid columns are qsy-strided); Bx likewise for x. All entries
    <= 16, so bf16 operands are exact and the f32 accumulation of the
    integer products never rounds."""
    tw, th = 1 << sx, 1 << sy
    qsy, qsx = th // 4, tw // 4
    H, W = nty * th, ntx * tw
    By = np.zeros((H, qh), np.float32)
    ys = np.arange(H)
    ty, ry = ys // th, ys % th
    By[ys, ty * qsy] += th - ry
    By[ys, ty * qsy + qsy] += ry
    Bx = np.zeros((qw, W), np.float32)
    xs = np.arange(W)
    tx, rx = xs // tw, xs % tw
    Bx[tx * qsx, xs] += tw - rx
    Bx[tx * qsx + qsx, xs] += rx
    return By.astype(jnp.bfloat16), Bx.astype(jnp.bfloat16)


def _blend_values(corners, accept, sx, sy):
    """Bilinear tile fill values for one gradient pass: [3, nty*th, ntx*tw]
    plus the [nty*th, ntx*tw] accept mask (exact YAIK_Gradient.cpp
    fixed-point semantics).

    Computed as TWO constant matmuls per channel (vals = By @ cg @ Bx,
    see _blend_mats). The y-blend result t <= 255*16 exceeds bf16's 8
    integer bits, so the x-matmul runs on an exact hi/lo byte split (each
    half <= 255, recombined *256 in f32: every intermediate < 2^24 stays
    integer-exact, whatever the accumulation order)."""
    tw, th = 1 << sx, 1 << sy
    nty, ntx = accept.shape
    qh, qw = corners.shape[0], corners.shape[1]
    By, Bx = _blend_mats(nty, ntx, qh, qw, sx, sy)
    cg = jnp.moveaxis(corners, -1, 0).astype(jnp.bfloat16)   # [3, qh, qw]
    t = jnp.einsum("yi,cij->cyj", By, cg,
                   preferred_element_type=jnp.float32)
    ti = t.astype(jnp.int32)                                 # <= 4080 exact
    t_hi = (ti >> 8).astype(jnp.bfloat16)                    # <= 15
    t_lo = (ti & 0xFF).astype(jnp.bfloat16)                  # <= 255
    v = (jnp.einsum("cyj,jx->cyx", t_hi, Bx,
                    preferred_element_type=jnp.float32) * 256.0
         + jnp.einsum("cyj,jx->cyx", t_lo, Bx,
                      preferred_element_type=jnp.float32))
    shift = (th.bit_length() - 1) + (tw.bit_length() - 1)
    vals = v.astype(jnp.int32) >> shift
    mask = jnp.repeat(jnp.repeat(accept, th, axis=0), tw, axis=1)
    return vals, mask


def _mask_blend(plane, vp, m32, H, W):
    """Bitwise masked blend of the packed-u32 plane: copy exactly the bits
    selected by m32 from vp (out = plane ^ ((plane ^ vp) & m32))."""
    if (H, W) == plane.shape:
        return plane ^ ((plane ^ vp) & m32)
    region = plane[:H, :W]
    return plane.at[:H, :W].set(region ^ ((region ^ vp) & m32))


def _blend_pass(plane, accept, corners, sx, sy, chmask=0xFFFFFF):
    """One gradient pass: fill accepted tiles with the exact bilinear.
    The blend is a convex combination of u8 corners (weights sum to th*tw,
    then >>shift) so each channel is provably 0..255; channels pack into
    the u32 plane word and chmask restricts the write to the pass's plane
    subset (the GTIL plane != 7 variants)."""
    tw, th = 1 << sx, 1 << sy
    nty, ntx = accept.shape
    if nty == 0 or ntx == 0:
        return plane
    vals, mask = _blend_values(corners, accept, sx, sy)
    vp = (vals[0] | (vals[1] << 8) | (vals[2] << 16)).astype(jnp.uint32)
    m32 = mask.astype(jnp.uint32) * chmask
    return _mask_blend(plane, vp, m32, nty * th, ntx * tw)


def _tile_to_image(vals, nty, ntx, th, tw):
    """[..., nty*ntx, th*tw] tile-major -> [..., nty*th, ntx*tw] image."""
    lead = vals.shape[:-2]
    v = vals.reshape(lead + (nty, ntx, th, tw))
    perm = tuple(range(len(lead))) + tuple(
        len(lead) + i for i in (0, 2, 1, 3))
    return v.transpose(perm).reshape(lead + (nty * th, ntx * tw))


def _lut_resolve(lut_tab, rows, packed):
    """Per-pixel LUT words: lut_tab [R, K] i32 (packed table rows), rows
    [g] i32 (each tile's row), packed [g, npx] u8 idx|wmask<<6 -> [g, npx]
    i32 lut_tab[rows[t], idx]. ONE integer gather from the flat table (no
    [g, K] per-tile row table in between), so the packed 24-bit words come
    back exact whatever the device's matmul precision."""
    idx = (packed & 63).astype(jnp.int32)
    flat = rows.astype(jnp.int32)[:, None] * lut_tab.shape[1] + idx
    return lut_tab.reshape(-1)[flat]


def _tile3d_pass(plane, lut_tab, accept, rows, colors, packed, sx, sy):
    """One 3D-LUT size pass over the full grid, channel-PACKED resolve.

    The global table carries all 3 channels packed into one i32 per entry
    (c0 | c1<<8 | c2<<16; entries are <= 128 so fields never interact).
    Each tile carries its table ROW (from its type word) and index+mask
    pack into one byte per pixel. The per-pixel channels pack into one
    i32 with the write mask (wmask & accept) in bit 24, so the pass needs
    exactly ONE tile->image relayout and the unpack fuses into the
    bitwise blend."""
    tw, th = 1 << sx, 1 << sy
    nty, ntx = accept.shape
    g = packed.shape[0]
    colors = colors.astype(jnp.int32)
    Lp = _lut_resolve(lut_tab, rows, packed)              # [g, npx]
    L = jnp.stack([Lp & 0xFF, (Lp >> 8) & 0xFF, Lp >> 16], axis=0)
    mn = colors.T[0:3, :, None]                           # [3, g, 1]
    diff = colors.T[3:6, :, None] - mn
    vals = (mn + ((diff * L) >> 7)) & 0xFF                # [3, g, npx]
    write = (packed >> 6).astype(jnp.int32) * \
        accept.reshape(g, 1).astype(jnp.int32)
    Vp = vals[0] | (vals[1] << 8) | (vals[2] << 16) | (write << 24)
    V = _tile_to_image(Vp, nty, ntx, th, tw).astype(jnp.uint32)  # [H, W]
    m32 = (V >> 24) * 0xFFFFFF           # write bit -> all-channel mask
    return _mask_blend(plane, V, m32, nty * th, ntx * tw)


def _pack_d1_blocks(plan: "plannermod.DecodePlan"):
    """Plan-time 4x4-block-space packing of the 1D residual pass
    (host numpy): returns (prm [5, G4] i32, codes4 [12, G4] i32,
    wm2 [2, G4] i32) - the operand form _d1_vals_tile reads (see there
    for the field layout). Block (ty4, tx4) maps to 8x8 tile
    (ty4>>1, tx4>>1), quadrant (ty4&1, tx4&1)."""
    h, w = plan.height, plan.width
    nty8, ntx8 = h // 8, w // 8
    nty4, ntx4 = h // 4, w // 4
    G4 = nty4 * ntx4

    def to_blocks(a):             # [3, g8, 64] -> [3, G4, 16]
        b = a.reshape(3, nty8, ntx8, 2, 4, 2, 4)
        return np.ascontiguousarray(
            b.transpose(0, 1, 3, 2, 5, 4, 6)).reshape(3, G4, 16)

    # byte packs are zero-copy u32 views of the contiguous block layout
    # (little-endian: byte j of lane l = pixel 4l+j) and the bit pack is
    # np.packbits - the arithmetic forms measured ~12 ms per 512^2 image
    # of host time on every plan-pack
    cb = to_blocks(plan.d1.indices)                        # [3, G4, 16] u8
    codes4 = np.ascontiguousarray(
        cb.view(np.uint32).transpose(0, 2, 1)).reshape(12, G4).view(
        np.int32)
    wmb = to_blocks(plan.d1.wmask.astype(np.uint8))
    w16 = np.packbits(wmb, axis=-1, bitorder="little")     # [3, G4, 2] u8
    wbits_c = w16.view("<u2")[:, :, 0].astype(np.uint32)   # [3, G4]
    wm2 = np.ascontiguousarray(np.stack(
        [wbits_c[0] | (wbits_c[1] << 16), wbits_c[2]])).view(np.int32)

    pr = plan.d1.params.astype(np.uint32)                  # [3, g8, 3]
    pb = pr.reshape(3, nty8, ntx8, 3)
    pb = np.repeat(np.repeat(pb, 2, axis=1), 2, axis=2).reshape(3, G4, 3)
    prm = np.ascontiguousarray(np.stack([
        pb[0, :, 0] | (pb[1, :, 0] << 8) | (pb[2, :, 0] << 16),
        pb[0, :, 1] | (pb[1, :, 1] << 8) | (pb[2, :, 1] << 16),
        pb[0, :, 2], pb[1, :, 2], pb[2, :, 2]],
        axis=0)).view(np.int32)
    return prm, codes4, wm2



_T2_ORDER = tuple((mode, shift) for mode in (0, 1, 2)
                  for shift in ((3, 3), (2, 2)))
_T2_PLANES = {0: (0, 1), 1: (1, 2), 2: (0, 2)}


def _tile2d_pass(plane, lut2_tab, accept, rows, colors, packed, mode, sx,
                 sy):
    """One 2DTL size pass: like _tile3d_pass but two channels
    (min + (diff * L) >> 7 on the pair planes; Tile2D_* semantics)."""
    pa, pb = _T2_PLANES[mode]
    tw, th = 1 << sx, 1 << sy
    nty, ntx = accept.shape
    g = packed.shape[0]
    colors = colors.astype(jnp.int32)
    Lp = _lut_resolve(lut2_tab, rows, packed)   # [g, npx] (c0 | c1<<8)
    L = jnp.stack([Lp & 0xFF, Lp >> 8], axis=0)
    mn = colors.T[0:2, :, None]
    diff = colors.T[2:4, :, None] - mn
    vals = (mn + ((diff * L) >> 7)) & 0xFF                # [2, g, npx]
    write = (packed >> 6).astype(jnp.int32) * \
        accept.reshape(g, 1).astype(jnp.int32)
    Vp = ((vals[0] << (8 * pa)) | (vals[1] << (8 * pb)) | (write << 24))
    V = _tile_to_image(Vp, nty, ntx, th, tw).astype(jnp.uint32)
    m32 = (V >> 24) * ((0xFF << (8 * pa)) | (0xFF << (8 * pb)))
    return _mask_blend(plane, V, m32, nty * th, ntx * tw)


_PGRAD_PAIRS = (5, 3, 6)      # RB, RG, GB 4x4 emission order
_PGRAD_SINGLES = (1, 2, 4)    # R, G, B


def _blend_pass_masked(plane, accept, corners, mask, sx, sy):
    """_blend_pass writing only the planes in `mask` (static) - the
    plane-variant GTIL chunks (GTIL plane != 7)."""
    ch = sum(0xFF << (8 * p) for p in range(3) if mask & (1 << p))
    return _blend_pass(plane, accept, corners, sx, sy, chmask=ch)


def _d1_vals_tile(prm, codes4, wm2):
    """The 1D residual values in 4x4-block TILE space [16, G4] i32:
    value bytes + per-channel write bits in bits 24-26. Per-channel
    write bits ride the SAME word as the values, so mask and values
    share one tile->image relayout.

    All operands are 4x4-BLOCK-space, byte/bit-packed at plan time
    (_pack_d1_blocks): prm [5, G4] i32 (color0 packed, base packed,
    delta2 per channel), codes4 [12, G4] i32 (per-channel index bytes, 4
    px per lane), wm2 [2, G4] i32 (per-(channel, pixel) write bits).
    delta2 needs up to 21 bits ((delta*inv_range)>>8, inv_range =
    2^24/range) so it rides its own lane per channel - but the resulting
    8-bit values pack."""
    c0 = [(prm[0] >> (8 * c)) & 0xFF for c in range(3)]       # [G4]
    bs = [(prm[1] >> (8 * c)) & 0xFF for c in range(3)]
    d2 = [prm[2 + c] for c in range(3)]
    vrows = []
    for p in range(16):
        vb, wb = [], []
        for c in range(3):
            L = (codes4[4 * c + (p >> 2)] >> (8 * (p & 3))) & 0xFF
            v = jnp.where(L != 0,
                          (bs[c] + (((L - 1) * d2[c]) >> 16)) & 0xFF,
                          c0[c])
            bitpos = c * 16 + p
            vb.append(v)
            wb.append((wm2[bitpos >> 5] >> (bitpos & 31)) & 1)
        vrows.append((vb[0] | (vb[1] << 8) | (vb[2] << 16)
                      | (wb[0] << 24) | (wb[1] << 25)
                      | (wb[2] << 26))[None])
    return jnp.concatenate(vrows, axis=0)                     # [16, G4]


def _d1_pass(plane, prm, codes4, wm2, h8, w8):
    """1D residual for all 3 planes: block-space values, one tile->image
    relayout, per-channel masked blend."""
    nty4, ntx4 = h8 // 4, w8 // 4
    vpT = _d1_vals_tile(prm, codes4, wm2)                     # [16, G4]
    v_img = _tile_to_image(vpT.T, nty4, ntx4, 4, 4).astype(jnp.uint32)
    m32 = (((v_img >> 24) & 1) * 0xFF | ((v_img >> 25) & 1) * 0xFF00
           | ((v_img >> 26) & 1) * 0xFF0000)
    return plane ^ ((plane ^ v_img) & m32)


def salt_d1_color0(prm, s):
    """Bench harness hook: perturb every channel's color0 byte by +s
    (mod 256) in the packed d1 params - the round-2 salted-chain data
    dependence, expressed on the block-space operand form. Works on
    batched stacks [..., 5, G4]."""
    p0 = prm[..., 0:1, :]
    nb = ((((p0 >> 0) & 0xFF) + s) & 0xFF) \
        | (((((p0 >> 8) & 0xFF) + s) & 0xFF) << 8) \
        | (((((p0 >> 16) & 0xFF) + s) & 0xFF) << 16)
    return prm.at[..., 0:1, :].set(nb)


def _unpack6_device(raw, count, inverse):
    """count 6-bit values from a 3-byte-group stream -> u8 (v<<2 | v>>4),
    fully dense (reshape + shifts, no gather). raw must be padded to a
    3-byte multiple covering count values (AlphaPlan guarantees it)."""
    n3 = ((count * 6 + 7) // 8 + 2) // 3
    b = raw[: n3 * 3].reshape(n3, 3).astype(jnp.int32)
    v0 = b[:, 0] & 0x3F
    v1 = (b[:, 0] >> 6) | ((b[:, 1] & 0xF) << 2)
    v2 = (b[:, 1] >> 4) | ((b[:, 2] & 0x3) << 4)
    v3 = b[:, 2] >> 2
    v = jnp.stack([v0, v1, v2, v3], axis=1).reshape(-1)[:count]
    if inverse:
        v = 63 - v
    return ((v << 2) | (v >> 4)).astype(jnp.uint8)


def _mip_mask_device(mip_bits, mspec, h8, w8):
    """MIPM tile bits -> [h8, w8] bool mask (static grid/origin, clipped at
    the image edge like the host decoder)."""
    mw, mh, x0, y0, ts = mspec
    bits = ((mip_bits[:, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
            ).reshape(-1)[: mw * mh] != 0
    sub = jnp.repeat(jnp.repeat(bits.reshape(mh, mw), ts, 0), ts, 1)
    sh = min(mh * ts, h8 - y0)
    sw = min(mw * ts, w8 - x0)
    mask = jnp.zeros((h8, w8), bool)
    return mask.at[y0:y0 + sh, x0:x0 + sw].set(sub[:sh, :sw])


def _alpha_pass(aspec, raw, mip_bits, h8, w8):
    """ALPM decode on device: [h8, w8] u8 alpha. aspec is the STATIC
    (mode, bbox, mip_spec) plan so every mode lowers to dense reshapes and
    one static-position update (sparse adds a cumsum + one gather).
    Byte-identical to decoder/alpha.py (YAIK_Alpha.cpp:25-377 hot loops)."""
    mode, (bx, by, bw, bh), mspec = aspec
    if mode == 0:          # has_alpha but no ALPM chunk: constant 255
        return jnp.full((h8, w8), 255, jnp.uint8)
    if mode == 1:          # 1-bit full
        nbytes = (bw * bh + 7) // 8
        bits = ((raw[:nbytes, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1
                ).reshape(-1)[: bw * bh]
        region = (bits * jnp.uint8(255)).reshape(bh, bw)
    elif mode in (4, 5):   # 6-bit full (/inverse)
        region = _unpack6_device(raw, bw * bh, mode == 5).reshape(bh, bw)
    elif mode in (2, 3):   # 6-bit sparse over the mipmap mask (/inverse)
        mask = _mip_mask_device(mip_bits, mspec, h8, w8)
        sel = mask[by:by + bh, bx:bx + bw]
        k = jnp.cumsum(sel.reshape(-1).astype(jnp.int32)) - 1
        vals = _unpack6_device(raw, bw * bh, mode == 3)
        picked = jnp.take(vals, jnp.maximum(k, 0)).reshape(bh, bw)
        region = jnp.where(sel, picked, jnp.uint8(0))
    elif mode == 6:        # 8-bit full
        region = raw[: bw * bh].reshape(bh, bw)
    else:
        raise ValueError(f"unsupported alpha mode {mode}")
    alpha = jnp.zeros((h8, w8), jnp.uint8)
    return alpha.at[by:by + bh, bx:bx + bw].set(region)


def decode_core(shifts, lut_tab, grad_accepts, grad_corners,
                t3_accepts, t3_rows, t3_colors, t3_packed,
                d1_prm, d1_codes4, d1_wm2,
                ucol=None, t2=None, pgrad_pairs=None, pgrad_singles=None,
                alpha=None, aspec=None):
    """ucol: None or the pre-pass overlay (vals [3,h8,w8] u8 planar, mask
    packbits [h8,w8/8] u8) carrying UCOL + SMAP pixels - applied first, in
    stream order. t3_*: 2 merged 4x4 layers (t3_merge_plan) or the 6 size
    passes in T3_SHIFTS order. t2: None or (lut2_tab [C,64] i32, 6x
    (accept, rows, colors, packed)) in _T2_ORDER. Returns [h8, w8, 3] u8
    ([h8, w8, 4] with aspec)."""
    # image dims (multiples of 8) from the 4x4 3D pass grid
    nty4, ntx4 = t3_accepts[-1].shape
    h8, w8 = nty4 * 4, ntx4 * 4
    # merged-T3 layout is carried by the pytree structure itself (2 layers
    # instead of 6 size passes) so no extra static argument is needed and
    # jit re-specializes automatically
    t3_shift_list = MERGED_T3_SHIFTS if len(t3_accepts) == 2 else T3_SHIFTS

    plane = jnp.full((h8, w8), 0x808080, jnp.uint32)
    if ucol is not None:
        ov_vals, ov_bits = ucol        # overlay (UCOL + SMAP, stream order)
        m = (((ov_bits[:, :, None] >> jnp.arange(8, dtype=jnp.uint8)) & 1)
             .reshape(h8, w8).astype(jnp.uint32))
        vp = (ov_vals[0].astype(jnp.uint32)
              | (ov_vals[1].astype(jnp.uint32) << 8)
              | (ov_vals[2].astype(jnp.uint32) << 16))
        plane = plane ^ ((plane ^ vp) & (m * 0xFFFFFF))
    for k, (sx, sy) in enumerate(shifts):
        plane = _blend_pass(plane, grad_accepts[k], grad_corners[k], sx, sy)
    for k, (sx, sy) in enumerate(t3_shift_list):
        plane = _tile3d_pass(plane, lut_tab, t3_accepts[k], t3_rows[k],
                             t3_colors[k], t3_packed[k], sx, sy)
    if pgrad_pairs is not None:     # GTIL plane in (5, 3, 6), before 2DTL
        for k, mask in enumerate(_PGRAD_PAIRS):
            plane = _blend_pass_masked(plane, *pgrad_pairs[k], mask, 2, 2)
    if t2 is not None:
        lut2_tab, t2passes = t2
        for k, (mode, (sx, sy)) in enumerate(_T2_ORDER):
            plane = _tile2d_pass(plane, lut2_tab, *t2passes[k], mode, sx, sy)
    if pgrad_singles is not None:   # GTIL plane in (1, 2, 4), after 2DTL
        for k, mask in enumerate(_PGRAD_SINGLES):
            plane = _blend_pass_masked(plane, *pgrad_singles[k], mask, 2, 2)
    plane = _d1_pass(plane, d1_prm, d1_codes4, d1_wm2, h8, w8)
    # The plane IS the channel-packed u32 word (r | g<<8 | b<<16); the
    # final interleave is just the bitcast to [H, W, 4] u8 - byte-exact
    # on little-endian backends. Alpha rides bits 24-31.
    if aspec is not None:
        raw, mip_bits = alpha if alpha is not None else (None, None)
        a = _alpha_pass(aspec, raw, mip_bits, h8, w8)
        plane = plane | (a.astype(jnp.uint32) << 24)
        return jax.lax.bitcast_convert_type(plane, jnp.uint8)
    return jax.lax.bitcast_convert_type(plane, jnp.uint8)[:, :, :3]


decode_pixels = partial(jax.jit,
                        static_argnames=("shifts", "aspec"))(decode_core)
# batched decode lives in yaik_tpu.parallel.batch._batched_decoder (vmap
# over the per-image arg pytree; LUT table and the static alpha spec shared)


_LUT_TAB_CACHE: dict = {}


def lut_device_table(expanded: dict):
    """Global device LUT table: per-bit expanded tables padded to 64 points
    and concatenated, 3 channels PACKED into one i32 per entry
    (c0 | c1<<8 | c2<<16, entries <= 128 so the packed value < 2^24) ->
    ([C, 64] i32, row base per bit). Cached per expanded-dict identity
    (one upload per bank)."""
    key = id(expanded)
    hit = _LUT_TAB_CACHE.get(key)
    if hit is not None:
        return hit[0], hit[1]
    parts, bases, off = [], {}, 0
    for bit in (3, 4, 5, 6):
        t = expanded[bit].astype(np.int32)      # [n_b, 2^bit, 3]
        pad = np.zeros((t.shape[0], 64), np.int32)
        pad[:, : t.shape[1]] = t[:, :, 0] | (t[:, :, 1] << 8) | (
            t[:, :, 2] << 16)
        bases[bit] = off
        off += t.shape[0]
        parts.append(pad)
    tab = jax.device_put(np.concatenate(parts, axis=0))
    # keep a reference to the dict so its id can never be recycled to a
    # different bank while the cache entry lives
    _LUT_TAB_CACHE[key] = (tab, bases, expanded)
    return tab, bases


def lut2d_device_table(expanded2d: dict):
    """2D analog of lut_device_table: [C, 64] i32 (2 channels packed as
    c0 | c1<<8) + per-bit row bases.

    Rows are cut as 128-byte windows of the FLAT per-bit section rather than
    zero-padded blocks: 3-bit tiles legitimately index past their 16-byte
    block into the next pattern's entries (the encoder's 4-bit-map idx3Bit
    bug, EncoderContext.cpp:5642; the reference decoder reads straight
    through its contiguous table memory, YAIK_3DTile.cpp:2255)."""
    key = ("2d", id(expanded2d))
    hit = _LUT_TAB_CACHE.get(key)
    if hit is not None:
        return hit[0], hit[1]
    parts, bases, off = [], {}, 0
    for bit in (3, 4, 5, 6):
        t = expanded2d[bit]                     # [n*8, 2^bit, 2]
        n_rows = t.shape[0]
        flat = np.concatenate([t.reshape(-1).astype(np.uint8),
                               np.zeros(128, np.uint8)])
        row_size = t.shape[1] * 2
        starts = np.arange(n_rows) * row_size
        pad = flat[starts[:, None] + np.arange(128)].reshape(
            n_rows, 64, 2).astype(np.int32)
        bases[bit] = off
        off += n_rows
        parts.append(pad[:, :, 0] | (pad[:, :, 1] << 8))
    tab = jax.device_put(np.concatenate(parts, axis=0))
    _LUT_TAB_CACHE[key] = (tab, bases, expanded2d)
    return tab, bases


def _t2_rows_full(p, expanded2d, bases2):
    """Full 2D-table row per tile of one 2DTL pass (type-word decode +
    clamp; mirrors the host planner's table addressing)."""
    t = p.types.astype(np.int64) & 0xFFFF
    bi = (t >> 14) & 3
    n2 = np.array([expanded2d[b].shape[0] for b in (3, 4, 5, 6)])
    b2 = np.array([bases2[b] for b in (3, 4, 5, 6)], np.int64)
    comb = np.minimum(t & 0x3FFF, n2[bi] - 1)
    return (b2[bi] + comb).astype(np.int32)


def _t3_rows_full(p, base_arr, nrows):
    """Full LUT-table row per tile of one T3 pass (same type-word decode +
    clamp as the host planner, YAIK_3DTile.cpp type words)."""
    t = p.types.astype(np.int64) & 0xFFFF
    bi = (t >> 14) & 3
    comb = np.minimum(t & 0x3FFF, nrows[bi] - 1)
    return (base_arr[bi] + comb).astype(np.int32)


def _lut_bases_arrays(expanded):
    _, bases = lut_device_table(expanded)
    base_arr = np.zeros(4, np.int64)
    nrows = np.zeros(4, np.int64)
    for bi, bit in enumerate((3, 4, 5, 6)):
        base_arr[bi] = bases[bit]
        nrows[bi] = expanded[bit].shape[0]
    return base_arr, nrows


def t3_merge_plan(plan: plannermod.DecodePlan, expanded: dict,
                  max_layers: int = 2):
    """Re-block ALL Tile3D size passes onto the uniform 4x4 grid.

    Every T3 tile size is a multiple of 4x4, so each accepted tile scatters
    its LUT row / colors / idx bytes onto its covering 4x4 blocks. Blocks
    covered by tiles from k different passes land on k priority LAYERS in
    stream-pass order, so blending layer 0 then layer 1 reproduces the
    sequential 6-pass semantics exactly (later passes win, per-pixel write
    bits ride bit 6 of the idx byte unchanged). Measured streams need
    <= 2 layers (accepted tiles of different passes rarely share a block
    and their written pixels are disjoint); returns None when a block
    needs more - callers fall back to the per-size passes.

    Returns a tuple of layers (accept4 [nty4, ntx4], rows4 [G4] full table
    rows, colors4 [G4, 6] u8, packed4 [G4, 16] u8). Cached on the plan
    (the feasibility probe and the arg packer would otherwise both pay
    it)."""
    cached = getattr(plan, "_t3_merge_cache", None)
    if cached is not None and cached[0] is expanded:
        return cached[1]
    h, w = plan.height, plan.width
    nty4, ntx4 = h // 4, w // 4
    G4 = nty4 * ntx4
    base_arr, nrows = _lut_bases_arrays(expanded)
    count = np.zeros(G4, np.uint8)
    lay_acc = [np.zeros(G4, bool) for _ in range(max_layers)]
    lay_rows = [np.zeros(G4, np.int32) for _ in range(max_layers)]
    lay_cols = [np.zeros((G4, 6), np.uint8) for _ in range(max_layers)]
    lay_pk = [np.zeros((G4, 16), np.uint8) for _ in range(max_layers)]
    by_shift = {p.shift: p for p in plan.tile3d}
    result = None
    ok = True
    for (sx, sy) in T3_SHIFTS:
        p = by_shift.get((sx, sy))
        if p is None:
            continue
        tw, th = 1 << sx, 1 << sy
        nty, ntx = p.accept.shape
        ids = np.flatnonzero(p.accept.reshape(-1))
        if ids.size == 0:
            continue
        nsy, nsx = th // 4, tw // 4
        nsub = nsy * nsx
        ty, tx = ids // ntx, ids % ntx
        by = ty[:, None, None] * nsy + np.arange(nsy)[None, :, None]
        bx = tx[:, None, None] * nsx + np.arange(nsx)[None, None, :]
        g4 = (by * ntx4 + bx).reshape(-1)                 # [n*nsub]
        pk = p.packed[ids].reshape(-1, nsy, 4, nsx, 4).transpose(
            0, 1, 3, 2, 4).reshape(-1, 16)                # g4-ordered
        rows_sub = np.repeat(_t3_rows_full(p, base_arr, nrows)[ids], nsub)
        cols_sub = np.repeat(p.colors[ids].astype(np.uint8), nsub, axis=0)
        cur = count[g4]
        if int(cur.max(initial=0)) >= max_layers:
            ok = False
            break
        for L in range(max_layers):
            sel = cur == L
            if not sel.any():
                continue
            t = g4[sel]
            lay_acc[L][t] = True
            lay_rows[L][t] = rows_sub[sel]
            lay_cols[L][t] = cols_sub[sel]
            lay_pk[L][t] = pk[sel]
        count[g4] = cur + 1                # g4 unique within one pass
    if ok:
        result = tuple(
            (lay_acc[L].reshape(nty4, ntx4), lay_rows[L], lay_cols[L],
             lay_pk[L]) for L in range(max_layers))
    try:
        plan._t3_merge_cache = (expanded, result)
    except AttributeError:
        pass
    return result


def t3_pack_mode(plan: plannermod.DecodePlan, expanded: dict) -> str:
    """T3 device packing for one plan: "merged" when the passes re-block
    onto <= 2 layers (t3_merge_plan), else "legacy" (the 6 size passes)."""
    if t3_merge_plan(plan, expanded) is not None:
        return "merged"
    return "legacy"


def batch_layout(plans, expanded: dict) -> tuple:
    """One device-arg structure for a batch of plans, so their pytrees
    stack: (t3 mode, with_overlay, with_2dtl, with_plane_gradients). T3 is
    "merged" only when every plan merges; an optional stage is present
    when any plan carries it, and the plans without it get an all-zero
    (no-write) version of it."""
    plans = list(plans)
    merged = all(t3_pack_mode(p, expanded) == "merged" for p in plans)
    return ("merged" if merged else "legacy",
            any(p.overlay is not None for p in plans),
            any(bool(p.tile2d) for p in plans),
            any(g.plane_mask != 7 for p in plans for g in p.gradient))


def plan_to_device_args(plan: plannermod.DecodePlan, expanded: dict,
                        expanded2d: dict | None = None,
                        layout: tuple | None = None):
    """Assemble (static shifts, lut table, per-image tensor args) from a
    plan. Per-image tensors are packed thin for the host->device link:
    LUT row ids instead of per-tile table slices, idx|mask<<6 bytes, u8
    colors. layout (batch_layout; default: the plan's own) fixes the arg
    structure - batch decode passes one layout for all its images so the
    stacked pytrees share one structure."""
    w, h = plan.width, plan.height
    qh, qw = h // 4 + 1, w // 4 + 1
    tab, _ = lut_device_table(expanded)
    by_shift = {g.shift: g for g in plan.gradient if g.plane_mask == 7}
    accepts, corners = [], []
    for (sx, sy) in GRAD_SHIFTS:
        tw, th = 1 << sx, 1 << sy
        g = by_shift.get((sx, sy))
        if g is None:
            accepts.append(np.zeros((h // th, w // tw), bool))
            corners.append(np.zeros((qh, qw, 3), np.uint8))
        else:
            accepts.append(g.accept)
            corners.append(g.corners)

    mode, with_overlay, with_t2, with_pgrad = (
        layout or batch_layout([plan], expanded))
    t3a, t3r, t3c, t3p = [], [], [], []
    if mode == "merged":
        layers = t3_merge_plan(plan, expanded)
        if layers is None:
            raise ValueError("merged T3 requested but plan needs >2 layers")
        for acc4, rows4, cols4, pk4 in layers:
            t3a.append(acc4)
            t3r.append(rows4)
            t3c.append(cols4)
            t3p.append(pk4)
    else:
        base_arr, nrows = _lut_bases_arrays(expanded)
        t3_by_shift = {p.shift: p for p in plan.tile3d}
        for (sx, sy) in T3_SHIFTS:
            tw, th = 1 << sx, 1 << sy
            ntx, nty = w // tw, h // th
            g = nty * ntx
            p = t3_by_shift.get((sx, sy))
            if p is None:
                t3a.append(np.zeros((nty, ntx), bool))
                t3r.append(np.zeros(g, np.int32))
                t3c.append(np.zeros((g, 6), np.uint8))
                t3p.append(np.zeros((g, th * tw), np.uint8))
                continue
            t3a.append(p.accept)
            t3r.append(_t3_rows_full(p, base_arr, nrows))
            t3c.append(p.colors.astype(np.uint8))     # min/max are 0..255
            # the planner already stores idx|wmask<<6 with idx clamped to
            # 63 (corrupt streams can carry byte//3 <= 85) - zero-copy here
            t3p.append(p.packed)

    d1_prm, d1_codes4, d1_wm2 = _pack_d1_blocks(plan)

    ucol_arg = None
    if plan.overlay is not None:
        wbits_ov = np.packbits(plan.overlay.mask.astype(np.uint8),
                               axis=-1, bitorder="little")
        # planar [3, h8, w8] for the device
        ucol_arg = (np.ascontiguousarray(
            np.moveaxis(plan.overlay.vals, -1, 0)), wbits_ov)
    elif with_overlay:
        ucol_arg = (np.zeros((3, h, w), np.uint8),
                    np.zeros((h, w // 8), np.uint8))

    t2_arg = None
    if plan.tile2d or with_t2:
        if expanded2d is None:
            raise ValueError("plan carries 2DTL passes but no 2D LUT given")
        tab2, bases2 = lut2d_device_table(expanded2d)
        by_key = {(p.mode, p.shift): p for p in plan.tile2d or ()}
        entries = []
        for mode2, (sx, sy) in _T2_ORDER:
            tw, th = 1 << sx, 1 << sy
            ntx, nty = w // tw, h // th
            g = nty * ntx
            p = by_key.get((mode2, (sx, sy)))
            if p is None:
                entries.append((np.zeros((nty, ntx), bool),
                                np.zeros(g, np.int32),
                                np.zeros((g, 4), np.uint8),
                                np.zeros((g, th * tw), np.uint8)))
                continue
            rows = _t2_rows_full(p, expanded2d, bases2)
            entries.append((p.accept, rows, p.colors.astype(np.uint8),
                            p.packed))
        t2_arg = (tab2, tuple(entries))

    pg_pairs = pg_singles = None
    variants = {g.plane_mask: g for g in plan.gradient if g.plane_mask != 7}
    if variants or with_pgrad:
        def slot(mask):
            g = variants.get(mask)
            if g is None:
                return (np.zeros((h // 4, w // 4), bool),
                        np.zeros((h // 4 + 1, w // 4 + 1, 3), np.uint8))
            return (g.accept, g.corners)
        pg_pairs = tuple(slot(m) for m in _PGRAD_PAIRS)
        pg_singles = tuple(slot(m) for m in _PGRAD_SINGLES)

    alpha_arg = None
    if alpha_spec_of(plan) is not None:
        ap = plan.alpha_plan
        raw = ap.raw if ap is not None else np.zeros(1, np.uint8)
        mip = (ap.mip.bits if ap is not None and ap.mip is not None
               else np.zeros(1, np.uint8))
        alpha_arg = (raw, mip)

    args = (tuple(accepts), tuple(corners),
            tuple(t3a), tuple(t3r), tuple(t3c), tuple(t3p),
            d1_prm, d1_codes4, d1_wm2, ucol_arg, t2_arg,
            pg_pairs, pg_singles, alpha_arg)
    return GRAD_SHIFTS, tab, args


def alpha_spec_of(plan: plannermod.DecodePlan):
    """The STATIC alpha spec of a plan: None (no alpha) or
    (mode, bbox, mip_spec) - hashable, part of the jit specialization.
    mode 0 = constant-255 fill (has_alpha, no ALPM chunk)."""
    if not plan.has_alpha:
        return None
    ap = plan.alpha_plan
    if ap is None:
        return (0, (0, 0, plan.width, plan.height), None)
    mspec = None
    if ap.mip is not None:
        mw, mh = ap.mip.grid
        x0, y0 = ap.mip.origin
        mspec = (mw, mh, x0, y0, 1 << ap.mip.level)
    return (ap.mode, ap.bbox, mspec)


def plnt_device_args(hdr, body: bytes, valid: np.ndarray | None = None):
    """Host planning for the PLNT device decode: parse the chunk (same
    stream semantics as decoder/reference.py:decode_plnt_plane), build the
    dense per-tile tensors. Returns (luts [T,16] i32, codes [T,64] i32
    pre-clamped to each tile's LUT length, vmask [T,64] bool, nty, ntx) or
    None when the bbox is empty. PLNT never had an upstream decoder
    (deprecated at YAIK_API.cpp:567); this is the device twin of our
    standalone plane reconstruction."""
    from yaik_tpu.decoder.reference import zstd
    from yaik_tpu.encoder.plnt import (curves_from, diff_range_decode,
                                       min_range_decode)
    h, w = hdr.h, hdr.w
    nty, ntx = h // 8, w // 8
    if nty == 0 or ntx == 0:
        return None
    usize = zstd.frame_content_size(body[:hdr.stream_size_tile_map])
    if usize is None or usize > nty * ntx * 2:
        raise ValueError("PLNT tile map size missing or out of bounds")
    types = np.frombuffer(
        zstd.decompress(body[:hdr.stream_size_tile_map], usize), "<u2")
    codes_packed = zstd.decompress(
        body[hdr.stream_size_tile_map:
             hdr.stream_size_tile_map + hdr.stream_size_tile_stream],
        hdr.expected_size_tile_stream)
    nib = np.frombuffer(codes_packed, np.uint8)
    flat = np.empty(nib.size * 2, np.uint8)
    flat[0::2] = nib & 0xF
    flat[1::2] = nib >> 4

    if valid is None:
        vm = np.ones((nty * ntx, 64), bool)
    else:
        v = valid[hdr.y:hdr.y + h, hdr.x:hdr.x + w]
        vm = v.reshape(nty, 8, ntx, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    counts = vm.sum(axis=1)
    live = counts > 0                      # tiles that consumed a type word
    if int(live.sum()) > len(types):
        raise ValueError("PLNT tile map shorter than claimed tiles")
    ends = np.cumsum(counts)
    if int(ends[-1]) > flat.size:
        raise ValueError("PLNT code stream shorter than claimed pixels")

    t_of = np.zeros(nty * ntx, np.int64)
    t_of[live] = types[:int(live.sum())]
    luts = np.zeros((nty * ntx, 16), np.int32)
    lens = np.zeros(nty * ntx, np.int32)
    for t in np.unique(t_of[live]):
        bn = min_range_decode(int(t) & 0x7F)
        dist = diff_range_decode((int(t) >> 7) & 0x3F, bn)
        lut = np.asarray(curves_from(bn, dist)[int(t) >> 13], np.int32)
        rows = live & (t_of == t)
        luts[rows, :len(lut)] = lut
        lens[rows] = len(lut)

    codes = np.zeros((nty * ntx, 64), np.int32)
    codes[vm] = flat[:int(ends[-1])]
    codes = np.minimum(codes, np.maximum(lens - 1, 0)[:, None])
    return (luts, codes, vm, nty, ntx)


@partial(jax.jit, static_argnames=("nty", "ntx"))
def decode_plnt_plane_device(luts, codes, vmask, nty, ntx):
    """Device twin of decode_plnt_plane's pixel stage: per-tile 16-entry
    LUT resolve (integer gather, exact) + masked assembly. Returns the
    [nty*8, ntx*8] i32 plane with -999 at never-written pixels."""
    L = jnp.take_along_axis(luts, codes, axis=1)
    vals = jnp.where(vmask, L, jnp.int32(-999))
    return _tile_to_image(vals, nty, ntx, 8, 8)


def decode(stream: bytes, lut) -> np.ndarray:
    """Full decode through the device path (host plan + device pixels)."""
    from yaik_tpu.utils import profiler
    expanded2d = None
    if isinstance(lut, (bytes, bytearray)):
        expanded = lutmod.expand_lut(lutmod.parse_lut_file(bytes(lut)))
    else:
        expanded = lut.expanded
        expanded2d = getattr(lut, "expanded2d", None)
    with profiler.stage("decode:plan"):
        plan = plannermod.build_plan(stream, expanded, expanded2d)
    with profiler.stage("decode:pack-args"):
        shifts, tab, args = plan_to_device_args(plan, expanded, expanded2d)
    with profiler.stage("decode:device"):
        out = decode_pixels(shifts, tab, *args,
                            aspec=alpha_spec_of(plan))
        return np.asarray(out)[: plan.height, : plan.width]
