"""Minimal PNG reader and writer on the standard library (zlib + struct).

Covers what the codec reads and writes: 8-bit grayscale, RGB and RGBA,
non-interlaced, with all five scanline filters (PNG spec section 9).
Anything else (palette, 16-bit, Adam7) raises ValueError.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # color type -> samples per pixel


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters: raw holds h rows of (filter byte, stride
    bytes). Sub and Up vectorize; Average and Paeth depend on the
    reconstructed left neighbour and run byte by byte."""
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f = int(rows[y, 0])
        x = rows[y, 1:]
        if f == 0:
            cur = x.copy()
        elif f == 1:
            cur = (x.reshape(-1, bpp).astype(np.int64).cumsum(axis=0)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif f == 2:
            cur = x + prior
        elif f in (3, 4):
            cur = bytearray(x.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if f == 3:
                    p = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    p = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[i] = (cur[i] + p) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: bad filter type {f} in row {y}")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [h, w] (gray), [h, w, 3] (RGB) or [h, w, 4] (RGBA)
    u8."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    pos, hdr, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n or len(data) < pos + 12 + n:
            raise ValueError("PNG: truncated chunk")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or comp or filt or interlace:
        raise ValueError(f"PNG: unsupported format (bit depth {depth}, "
                         f"color type {ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (w * ch + 1):
        raise ValueError("PNG: image data size does not match the header")
    px = _unfilter(raw, h, w * ch, ch)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, ch)


def read_png(path, rgb: bool = False) -> np.ndarray:
    """Read a PNG file. rgb=True returns [h, w, 3]: gray is replicated and
    alpha dropped (what PIL's convert("RGB") gives)."""
    with open(path, "rb") as f:
        img = decode_png(f.read())
    if rgb:
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)
        img = np.ascontiguousarray(img[:, :, :3])
    return img


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """[h, w], [h, w, 3] or [h, w, 4] u8 -> PNG bytes (filter None)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"PNG: expected uint8 pixels, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if img.ndim not in (2, 3) or ctype is None:
        raise ValueError(f"PNG: unsupported image shape {img.shape}")
    h, w = img.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * ch)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                          0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
