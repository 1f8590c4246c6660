#!/usr/bin/env python3
"""Per-HLO-op device-time profile of the batched encode dispatch (the
encoder's device side: fused gradient bundle + all six 3D passes with
compaction). Same aggregation as profile_decode_step.py, pointed at
encbatch._dispatch_batch so the values/score split is measured, not
inferred from micro-benchmarks with synthetic alive rates.
"""
import glob
import gzip
import json
import os
import pathlib
import sys
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import numpy as np
from PIL import Image

from yaik_tpu.encoder import bank as bankmod
from yaik_tpu.encoder import batch as encbatch
from yaik_tpu.encoder import device_pipeline as devp
from yaik_tpu.encoder.context import EncoderConfig

FIX = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"
B = int(os.environ.get("B", "8"))


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/yaik_enc_trace"
    bank = bankmod.load_bank(str(FIX / "Bank3D"))
    cfg = EncoderConfig()
    tables = devp.bank_device_tables(bank)
    img = np.asarray(Image.open(FIX / "img512.png").convert("RGB"))
    imgs = [np.ascontiguousarray(np.roll(img, 8 * i, axis=1))
            for i in range(B)]

    pall = encbatch._dispatch_batch(imgs, None, cfg, tables)
    pall.block_until_ready()                     # compile + warm
    with jax.profiler.trace(outdir):
        for _ in range(4):
            pall = encbatch._dispatch_batch(imgs, None, cfg, tables)
        pall.block_until_ready()

    traces = sorted(glob.glob(outdir + "/plugins/profile/*/*.trace.json.gz"))
    if not traces:
        print("no trace.json.gz found under", outdir)
        return
    with gzip.open(traces[-1], "rt") as f:
        tr = json.load(f)
    pid_names = {e["pid"]: e["args"].get("name", "")
                 for e in tr["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    per_name = defaultdict(float)
    total = 0.0
    for e in tr["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        pname = pid_names.get(e.get("pid"), "")
        if "/device:" not in pname:
            continue
        per_name[e["name"]] += e["dur"]
        total += e["dur"]
    print(f"total device us (4 steps): {total:.0f}  "
          f"=> {total/4/1e3:.2f} ms/step  ({total/4e3/B:.2f} ms/img)")
    for name, d in sorted(per_name.items(), key=lambda kv: -kv[1])[:40]:
        print(f"{d/4/1e3:9.3f} ms/step  {100*d/total:5.1f}%  {name}")


if __name__ == "__main__":
    main()
