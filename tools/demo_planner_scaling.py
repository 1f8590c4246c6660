#!/usr/bin/env python3
"""Multi-process planner scaling demo (VERDICT r3 #6).

End-to-end decode throughput rests on planning scaling across processes
while the card consumes resident batches. This demo MEASURES the
planners-vs-throughput line: N planner PROCESSES (JAX_PLATFORMS=cpu -
they never touch the card, which stays with the main process) each build full decode plans + device-arg packs for their share of a
stream corpus and ship them over a queue; the main process stacks,
uploads, and dispatches the resident checksum decode (the bench.py
e2e-resident path) and validates every batch's checksum.

On a one-core host the expected result is NO scaling (two planners
share one core); on a multi-core host the same script produces the
scaling curve.

Usage: python tools/demo_planner_scaling.py [N_planners ...]
"""
import multiprocessing as mp
import os
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

FIX = REPO / "tests" / "fixtures"
BATCH = int(os.environ.get("B", "32"))
NBATCH = int(os.environ.get("NBATCH", "6"))


def planner_worker(names, njobs, out_q):
    """Runs in a subprocess on the CPU backend: plan + pack device args."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(REPO))
    from yaik_tpu.decoder import jax_engine, planner
    from yaik_tpu.format import lut as lutmod
    expanded = lutmod.expand_lut(
        lutmod.parse_lut_file((FIX / "LutFile.lut").read_bytes()))
    streams = {n: (FIX / f"{n}.yaik").read_bytes() for n in names}
    layout = jax_engine.batch_layout(
        [planner.build_plan(streams[n], expanded) for n in names], expanded)
    out_q.put(("ready", None, None))
    for k in range(njobs):
        n = names[k % len(names)]
        p = planner.build_plan(streams[n], expanded)
        _, _, args = jax_engine.plan_to_device_args(p, expanded,
                                                    layout=layout)
        out_q.put(("job", n, args))
    out_q.put(("done", None, None))


def main():
    counts = [int(a) for a in sys.argv[1:]] or [1, 2]
    import jax
    import jax.numpy as jnp
    from yaik_tpu.decoder import jax_engine, planner
    from yaik_tpu.format import lut as lutmod
    expanded = lutmod.expand_lut(
        lutmod.parse_lut_file((FIX / "LutFile.lut").read_bytes()))
    names = ("img512", "img512b")
    streams = {n: (FIX / f"{n}.yaik").read_bytes() for n in names}
    want = {n: np.load(FIX / f"{n}.dec.npz")["rgb"] for n in names}
    plans = {n: planner.build_plan(streams[n], expanded) for n in names}
    h, w = plans["img512"].height, plans["img512"].width
    flat = np.arange(h * w * 3, dtype=np.uint64)
    wgt = ((flat * 2654435761) % (1 << 32)).astype(np.uint32).reshape(
        h, w, 3)
    chk_img = {n: int((want[n].astype(np.uint64) * wgt).sum() % (1 << 32))
               for n in names}
    layout = jax_engine.batch_layout([plans[n] for n in names], expanded)
    shifts, tab, args0 = jax_engine.plan_to_device_args(
        plans["img512"], expanded, layout=layout)
    tab = jax.device_put(np.asarray(tab))
    wgt_dev = jax.device_put(wgt)
    nargs = len(args0)
    vdec = jax.vmap(lambda t, *a: jax_engine.decode_core(shifts, t, *a),
                    in_axes=(None,) + (0,) * nargs)
    chk = jax.jit(lambda t, *a: jnp.sum(
        vdec(t, *a).astype(jnp.uint32) * wgt_dev[None], dtype=jnp.uint32))

    def rep(x):
        x = np.asarray(x)
        return np.broadcast_to(x[None], (BATCH,) + x.shape).copy()

    warm = jax.device_put(jax.tree.map(rep, args0))
    int(chk(tab, *warm))                                   # compile

    mp.set_start_method("spawn", force=True)
    print(f"# host cores: {os.cpu_count()}  batch={BATCH} "
          f"batches/run={NBATCH}", flush=True)
    lines = []
    for N in counts:
        total = NBATCH * BATCH
        per = total // N
        q: mp.Queue = mp.Queue(maxsize=4 * BATCH)
        procs = [mp.Process(target=planner_worker, args=(names, per, q))
                 for _ in range(N)]
        for p in procs:
            p.start()
        # workers start producing immediately after their "ready"; buffer
        # any early jobs while waiting so the warmup isn't timed but no
        # message is lost (a strict ready-first protocol deadlocks when a
        # fast worker fills the queue before a slow one says ready)
        ready, early = 0, []
        while ready < N:
            tag, n, a = q.get()
            if tag == "ready":
                ready += 1
            elif tag == "job":
                early.append((n, a))
        t0 = time.perf_counter()
        done, got, batch_names, batch_args, ok = 0, 0, [], [], True
        pending = None
        while done < N or got < total:
            if early:
                n, a = early.pop(0)
            else:
                tag, n, a = q.get()
                if tag == "done":
                    done += 1
                    continue
            batch_names.append(n)
            batch_args.append(a)
            got += 1
            if len(batch_args) == BATCH:
                stk = jax.tree.map(lambda *xs: np.stack(xs), *batch_args)
                handle = chk(tab, *jax.device_put(stk))
                expect = sum(chk_img[n] for n in batch_names) % (1 << 32)
                if pending is not None:
                    ph, pe = pending
                    ok &= int(ph) == pe
                pending = (handle, expect)
                batch_names, batch_args = [], []
        if pending is not None:
            ph, pe = pending
            ok &= int(ph) == pe
        dt = time.perf_counter() - t0
        for p in procs:
            p.join()
        mpix = total * w * h / dt / 1e6
        lines.append((N, mpix, ok))
        print(f"planners={N}: {mpix:6.2f} MPix/s e2e-resident "
              f"(checksums {'OK' if ok else 'FAIL'})", flush=True)
    return lines


if __name__ == "__main__":
    main()
