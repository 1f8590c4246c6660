#!/usr/bin/env python3
"""Time the encoder's device scoring bundle dispatch (the module whose
wall time bounds encode_scoring_mpix_s) - warm, synced, median of N. For
minute-scale iteration; the checksummed bench lane stays the
certification.

Usage: python tools/bench_encode_dispatch.py [reps]
"""
import os
import pathlib
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax  # noqa: E402

from yaik_tpu.encoder import bank as bankmod  # noqa: E402
from yaik_tpu.encoder import batch as encbatch  # noqa: E402
from yaik_tpu.encoder import device_pipeline as devp  # noqa: E402
from yaik_tpu.encoder.context import EncoderConfig  # noqa: E402
from yaik_tpu.utils import compile_cache, png  # noqa: E402

FIX = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"
B = int(os.environ.get("B", "8"))


def main():
    compile_cache.configure()
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 5
    bank = bankmod.load_bank(str(FIX / "Bank3D"))
    cfg = EncoderConfig()
    tables = devp.bank_device_tables(bank)
    img = png.read_png(FIX / "img512.png", rgb=True)
    imgs = [np.ascontiguousarray(np.roll(img, 8 * i, axis=1))
            for i in range(B)]
    h, w = img.shape[:2]
    caps = devp.pass_caps(w, h)
    fn = encbatch._all_batch_compact_fn(cfg.reject_factor, caps)
    perms = encbatch._perms_device(w, h)
    p8 = jax.device_put(np.ascontiguousarray(np.stack(
        [im.transpose(2, 0, 1) for im in imgs])))
    qpts, pts, factors = tables
    out = fn(p8, qpts, pts, factors, perms)
    out.block_until_ready()                        # compile + warm
    # checksum for regression safety during iteration
    chk = int(np.asarray(out).astype(np.uint64).sum() % (1 << 32))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(p8, qpts, pts, factors, perms).block_until_ready()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"dispatch: {med*1e3:.1f} ms/batch-of-{B} (min "
          f"{min(times)*1e3:.1f}) => {B*h*w/med/1e6:.2f} MPix/s synced  "
          f"out_checksum={chk}")


if __name__ == "__main__":
    main()
