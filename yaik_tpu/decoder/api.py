"""Public decode API (mirrors the reference C API flow:
YAIK_Init/YAIK_AssignLUT/YAIK_DecodeImagePre/YAIK_DecodeImage).

`assign_lut` parses + expands a LUT bank once ('LUL0' 3D banks and 'LU20'
2D banks - the reference's AssignLUT deprecates the latter, YAIK_API.cpp:
229-234; ours loads it for 2DTL streams); `decode_image` decodes one
stream. The default engine is the bit-exact host path; engine="jax" uses the
device engine (same results, validated in tests).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from yaik_tpu.decoder import reference
from yaik_tpu.format import lut as lutmod
from yaik_tpu.format.headers import FileHeader, MAGIC


@dataclass
class LutBank:
    tables: dict
    expanded: dict
    tables2d: dict | None = None
    expanded2d: dict | None = None

    def with_2d(self, lut2d_data: bytes) -> "LutBank":
        t2 = lutmod.parse_lut2d_file(lut2d_data)
        return LutBank(tables=self.tables, expanded=self.expanded,
                       tables2d=t2, expanded2d=lutmod.expand_lut2d(t2))


def assign_lut(lut_data: bytes, lut2d_data: bytes | None = None) -> LutBank:
    tables = lutmod.parse_lut_file(lut_data)
    bank = LutBank(tables=tables, expanded=lutmod.expand_lut(tables))
    if lut2d_data is not None:
        bank = bank.with_2d(lut2d_data)
    return bank


def decode_image_pre(stream: bytes):
    """Returns (width, height, has_alpha) like YAIK_DecodeImagePre."""
    fh = FileHeader.unpack(stream)
    if fh.tag != MAGIC:
        raise ValueError("not a YAIK stream")
    return fh.width, fh.height, fh.has_alpha


def decode_image(stream: bytes, lut: LutBank | bytes,
                 engine: str = "host") -> np.ndarray:
    if isinstance(lut, (bytes, bytearray)):
        lut = assign_lut(bytes(lut))
    if engine == "host":
        return reference.decode(stream, lut.expanded, lut.expanded2d)
    elif engine == "jax":
        from yaik_tpu.decoder import jax_engine
        return jax_engine.decode(stream, lut)
    raise ValueError(f"unknown engine {engine!r}")
