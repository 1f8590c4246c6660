#!/usr/bin/env python3
"""Capture a device trace of the batched decode step (the bench.py hot
loop) and print an aggregated per-op time table.

Usage: python tools/profile_decode_step.py [outdir]
Writes the xplane/trace.json.gz under outdir (default /tmp/yaik_trace) and
prints the top HLO ops by self time, aggregated by op kind, so kernel work
targets measured cost.
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
import jax.numpy as jnp
import numpy as np

from yaik_tpu.decoder import jax_engine, planner
from yaik_tpu.format import lut as lutmod

FIX = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"
BATCH = int(os.environ.get("YAIK_BENCH_BATCH", "32"))


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "/tmp/yaik_trace"
    expanded = lutmod.expand_lut(
        lutmod.parse_lut_file((FIX / "LutFile.lut").read_bytes()))
    stream = (FIX / "img512.yaik").read_bytes()
    plan = planner.build_plan(stream, expanded)
    shifts, tab, args = jax_engine.plan_to_device_args(plan, expanded)

    def rep(x):
        x = np.asarray(x)
        return np.broadcast_to(x[None], (BATCH,) + x.shape).copy()

    bargs = jax.device_put(jax.tree.map(rep, args))
    tab = jax.device_put(np.asarray(tab))
    nargs = len(bargs)
    vdec = jax.jit(jax.vmap(lambda t, *a: jax_engine.decode_core(shifts, t, *a),
                            in_axes=(None,) + (0,) * nargs))
    out = vdec(tab, *bargs)
    out.block_until_ready()                      # compile + warm
    with jax.profiler.trace(outdir):
        for _ in range(4):
            out = vdec(tab, *bargs)
        out.block_until_ready()

    traces = sorted(glob.glob(outdir + "/plugins/profile/*/*.trace.json.gz"))
    if not traces:
        print("no trace.json.gz found under", outdir)
        return
    with gzip.open(traces[-1], "rt") as f:
        tr = json.load(f)
    # device op events live on the /device: planes; aggregate by name
    pid_names = {e["pid"]: e["args"].get("name", "")
                 for e in tr["traceEvents"]
                 if e.get("ph") == "M" and e.get("name") == "process_name"}
    by_op = defaultdict(float)
    total = 0.0
    for e in tr["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        pname = pid_names.get(e.get("pid"), "")
        if "/device:" not in pname:
            continue
        name = e["name"]
        # collapse fusion instance suffixes: fusion.123 -> fusion
        base = name.split(".")[0]
        by_op[(base, name)] = by_op[(base, name)] + e["dur"]
        total += e["dur"]
    per_name = defaultdict(float)
    for (base, name), d in by_op.items():
        per_name[name] += d
    print(f"total device us (4 steps): {total:.0f}  "
          f"=> {total/4/1e3:.2f} ms/step")
    for name, d in sorted(per_name.items(), key=lambda kv: -kv[1])[:40]:
        print(f"{d/4/1e3:9.3f} ms/step  {100*d/total:5.1f}%  {name}")


if __name__ == "__main__":
    main()
