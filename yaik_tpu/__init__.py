"""yaik_tpu: a JAX rebuild of the YAIK tile-based image codec.

Reference: KLab/YAIK (C++). This package re-expresses the codec for an
accelerator: host-side chunk demux / entropy (zstd + palette codec) + JAX
device code for all pixel work, with bit-exact stream compatibility
against the C++ reference.

Layout:
  format/   - bitstream structs, swizzle spec, LUT bank + expansion
  entropy/  - zstd binding (pinned 1.3.4 behavior when available) + palette codec
  decoder/  - host demux + decode planner + device kernels
  encoder/  - batched tile-fitting passes + stream emission
  parallel/ - mesh sharding for batch encode/decode
  utils/    - PNG io, stats, timing
"""

__version__ = "0.1.0"

from yaik_tpu.decoder.api import decode_image, assign_lut  # noqa: F401
