"""Per-chunk visual debug dumps - the reference's de facto test method.

The reference decoder snapshots its plane state and 4x4 claim mask as
PNGs after every chunk in YAIK_DEVEL builds (Debug_RGBandTILE,
/root/reference/decoder/YAIK_API.cpp:546-556, called at :955-1194;
DumpColorMap888Swizzle / Dump4x4TileMap in YAIK_GenericFunctions.cpp:15-118)
and the encoder dumps accept maps (debug1BitAsPng, EncoderContext.cpp:299).
Visual diffing against those dumps was the upstream workflow; this module
is the rebuild's analog.

Enable with YAIK_DEBUG_DUMP=<dir>: the host decoder then writes, after
every chunk,
    <dir>/<NN>_<TAG>_rgb.png     - current [H, W, 3] plane state
    <dir>/<NN>_<TAG>_claims.png  - per-plane 4x4 claim mask (R/G/B = plane)
and the host encoder writes per-pass accept maps
    <dir>/enc_<pass>_accept.png
Disabled (the default), every hook is a no-op costing one dict lookup.
"""
import itertools
import os
import threading

import numpy as np

# Per-decode state: each decode invocation gets its own snapshot
# numbering and (beyond the first in a process) its own subdirectory, so
# a second decode never continues/overwrites the first's numbering and
# concurrent decodes on different threads cannot race (ADVICE r4). The
# state is thread-local; the invocation sequence is a process-global
# atomic counter.
_SEQ = itertools.count()
_TLS = threading.local()


def _dir():
    return os.environ.get("YAIK_DEBUG_DUMP")


def enabled() -> bool:
    return bool(_dir())


def _save(path: str, arr: np.ndarray) -> None:
    from yaik_tpu.utils import png
    os.makedirs(os.path.dirname(path), exist_ok=True)
    png.write_png(path, arr)


def begin_decode() -> None:
    """Start a fresh snapshot numbering for this decode invocation (host
    decoder calls this at decode start when dumps are enabled). The first
    decode of a process writes into <dir> itself (the common interactive
    case keeps flat paths); later ones get <dir>/decNNN/."""
    seq = next(_SEQ)
    _TLS.sub = "" if seq == 0 else f"dec{seq:03d}"
    _TLS.n = 0


def snapshot_decode(tag: bytes, st) -> None:
    """Dump the decode state after one chunk (host decoder hook)."""
    d = _dir()
    if not d:
        return
    if not hasattr(_TLS, "n"):
        begin_decode()
    d = os.path.join(d, _TLS.sub) if _TLS.sub else d
    n = _TLS.n
    _TLS.n = n + 1
    name = tag.decode("ascii", "replace")
    rgb = np.ascontiguousarray(
        st.planes[:, : st.height, : st.width].transpose(1, 2, 0))
    _save(os.path.join(d, f"{n:02d}_{name}_rgb.png"), rgb)
    # claims [3, QH, QW] bool -> R/G/B channel per plane, like
    # Dump4x4TileMap's tile4x4Mask triple
    cl = (st.claims.astype(np.uint8) * 255).transpose(1, 2, 0)
    _save(os.path.join(d, f"{n:02d}_{name}_claims.png"),
          np.ascontiguousarray(cl))


def snapshot_accepts(pass_name: str, accept: np.ndarray) -> None:
    """Dump one encoder pass's accept bitmap (debug1BitAsPng analog)."""
    d = _dir()
    if not d:
        return
    _save(os.path.join(d, f"enc_{pass_name}_accept.png"),
          accept.astype(np.uint8) * 255)


def reset() -> None:
    """Restart numbering AND the invocation sequence (tests)."""
    global _SEQ
    _SEQ = itertools.count()
    _TLS.sub = ""
    _TLS.n = 0
