#!/usr/bin/env python3
"""Fast iteration harness for the chained device-decode lane (the
BENCH headline): same salted-checksum chain as bench.py, decode lane
only, configurable steps/batch, so kernel experiments get a validated
on-chip number in ~a minute instead of a full bench run.

Usage: python tools/bench_chain.py [steps] [batch]
"""
import os
import pathlib
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yaik_tpu.decoder import jax_engine, planner  # noqa: E402
from yaik_tpu.format import lut as lutmod  # noqa: E402
from yaik_tpu.utils import compile_cache  # noqa: E402

FIX = pathlib.Path(__file__).parent.parent / "tests" / "fixtures"


def main():
    compile_cache.configure()
    STEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 128
    expanded = lutmod.expand_lut(
        lutmod.parse_lut_file((FIX / "LutFile.lut").read_bytes()))
    names = ("img512", "img512b")
    streams = {n: (FIX / f"{n}.yaik").read_bytes() for n in names}
    want = {n: np.load(FIX / f"{n}.dec.npz")["rgb"] for n in names}
    plans = {n: planner.build_plan(streams[n], expanded) for n in names}
    w, h = plans["img512"].width, plans["img512"].height
    flat = np.arange(h * w * 3, dtype=np.uint64)
    wgt = ((flat * 2654435761) % (1 << 32)).astype(np.uint32).reshape(
        h, w, 3)

    layout = jax_engine.batch_layout([plans[n] for n in names], expanded)
    dev_args = {}
    for n in names:
        shifts, tab, args = jax_engine.plan_to_device_args(
            plans[n], expanded, layout=layout)

        def rep(x):
            x = np.asarray(x)
            return np.broadcast_to(x[None], (BATCH,) + x.shape).copy()

        dev_args[n] = jax.device_put(jax.tree.map(rep, args))
    nargs = len(dev_args["img512"])
    wgt_dev = jax.device_put(wgt)
    tab = jax.device_put(np.asarray(tab))
    vdec = jax.vmap(lambda t, *a: jax_engine.decode_core(shifts, t, *a),
                    in_axes=(None,) + (0,) * nargs)

    def batch_chk(t, s, a):
        a = list(a)
        a[jax_engine.D1_PRM_ARG] = jax_engine.salt_d1_color0(
            a[jax_engine.D1_PRM_ARG], s)
        out = vdec(t, *a)
        return jnp.sum(out.astype(jnp.uint32) * wgt_dev[None],
                       dtype=jnp.uint32)

    NSALT = 4
    chk_batch_s = {}
    for n in names:
        p = plans[n]
        aff = p.d1.wmask & (p.d1.indices == 0)
        nty, ntx = p.height // 8, p.width // 8
        aff_img = aff.reshape(3, nty, ntx, 8, 8).transpose(
            0, 1, 3, 2, 4).reshape(3, p.height, p.width)
        gold_pl = want[n].transpose(2, 0, 1).astype(np.uint64)
        wgt_pl = wgt.transpose(2, 0, 1).astype(np.uint64)
        base = int((gold_pl * wgt_pl).sum() % (1 << 32))
        gv, wv = gold_pl[aff_img], wgt_pl[aff_img]
        chk_batch_s[n] = [
            (BATCH * int((base + (wv * (((gv + s) & 0xFF) - gv)).sum())
                         % (1 << 32))) % (1 << 32) for s in range(NSALT)]

    @partial(jax.jit, static_argnames=("nsteps",))
    def pipeline(salt, t, a, b, nsteps):
        def body(i, carry):
            s1 = (carry & (NSALT - 1)).astype(jnp.int32)
            c1 = carry + batch_chk(t, s1, a)
            s2 = (c1 & (NSALT - 1)).astype(jnp.int32)
            return c1 + batch_chk(t, s2, b)
        return jax.lax.fori_loop(0, nsteps // 2, body, salt)

    def run_pipeline(salt, nsteps):
        r = pipeline(jnp.uint32(salt), tab, dev_args["img512"],
                     dev_args["img512b"], nsteps=nsteps)
        got = int(r)
        carry = salt
        for _ in range(nsteps // 2):
            for n in names:
                carry = (carry + chk_batch_s[n][carry & (NSALT - 1)]
                         ) % (1 << 32)
        return got == carry

    t0 = time.perf_counter()
    ok = run_pipeline(1, STEPS)          # compile + correctness
    print(f"# warm+compile {time.perf_counter()-t0:.1f}s checksum_ok={ok}",
          file=sys.stderr)
    rates = []
    for rep in range(3):
        t0 = time.perf_counter()
        ok &= run_pipeline(2 + rep, STEPS)
        dt = time.perf_counter() - t0
        rates.append(STEPS * BATCH * w * h / dt / 1e6)
    print(f"chained decode: {max(rates):.1f} MPix/s (runs: "
          f"{', '.join(f'{r:.1f}' for r in rates)}) checksum_ok={ok} "
          f"steps={STEPS} batch={BATCH}")
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
