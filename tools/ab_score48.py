#!/usr/bin/env python3
"""A/B of the encoder's scoring bundle on one GPU: the scoring form
(ops.score48 on the Triton route, or the plain XLA form) and the values
stage's chunk size (jax_scoring.VALUES_CHUNK_PX).

Each variant is the fused gradient + 3D compact scoring bundle
(encoder.batch._all_batch_compact_fn) for one batch of the bench encode
corpus (512^2 variants of img512.png / img512b.png), compiled ahead of
time. The variants then run in alternation, forward and back (A B C C B
A), so that clock and power drift fall on all of them. Every variant's
output must be byte-equal to the first's. Per variant it prints the
compile time, XLA's memory analysis of the dispatch (arguments, outputs,
temporaries) and the warm run times; --e2e also times encode_corpus of
the 96-image corpus per form, warm (the first, compiling call is not
counted), in the order A B B A.

Usage:
  python tools/ab_score48.py [--forms kernel,plain] [--chunks 49152]
      [--batches 8] [--reps 7] [--e2e] [--out results.json]
"""
import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

import jax  # noqa: E402

from yaik_tpu.encoder import bank as bankmod  # noqa: E402
from yaik_tpu.encoder import batch as encbatch  # noqa: E402
from yaik_tpu.encoder import device_pipeline as devp  # noqa: E402
from yaik_tpu.encoder import jax_scoring  # noqa: E402
from yaik_tpu.encoder.context import EncoderConfig  # noqa: E402
from yaik_tpu.utils import compile_cache, png  # noqa: E402

FIX = REPO / "tests" / "fixtures"
T0 = time.perf_counter()


def log(msg):
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def _corpus(n):
    from bench import _enc_variant
    base = [png.read_png(FIX / f"{name}.png", rgb=True)
            for name in ("img512", "img512b")]
    return [_enc_variant(base[i % 2], i) for i in range(n)]


def _set(form, chunk):
    """Point the scoring at one variant; the next trace picks it up."""
    jax_scoring._kernel_scoring = lambda: form == "kernel"
    jax_scoring.VALUES_CHUNK_PX = chunk
    jax.clear_caches()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--forms", default="kernel",
                    help="comma list of kernel, plain")
    ap.add_argument("--chunks", default=str(jax_scoring.VALUES_CHUNK_PX),
                    help="comma list of values-stage chunk sizes in pixels")
    ap.add_argument("--batches", default="8",
                    help="comma list of images per dispatch")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--e2e", action="store_true",
                    help="also time encode_corpus of 96 images per form")
    ap.add_argument("--out", default="",
                    help="also write the results as JSON to this file")
    a = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"ab_score48: needs a GPU, found {jax.devices()[0]}")
    compile_cache.configure()
    forms = a.forms.split(",")
    chunks = [int(c) for c in a.chunks.split(",")]
    batches = [int(b) for b in a.batches.split(",")]
    kernel_scoring, chunk0 = (jax_scoring._kernel_scoring,
                              jax_scoring.VALUES_CHUNK_PX)

    bank = bankmod.load_bank(str(FIX / "Bank3D"))
    cfg = EncoderConfig()
    tables = devp.bank_device_tables(bank)
    corpus = _corpus(96)
    h, w = corpus[0].shape[:2]
    caps = devp.pass_caps(w, h)
    perms = encbatch._perms_device(w, h)
    res = {"device": jax.devices()[0].device_kind, "variants": {}}

    runs = {}
    try:
        for B in batches:
            p8 = jax.device_put(np.ascontiguousarray(np.stack(
                [im.transpose(2, 0, 1) for im in corpus[:B]])))
            args = (p8, *tables, perms)
            want = None
            for form in forms:
                for chunk in chunks:
                    name = f"{form}/chunk{chunk}/B{B}"
                    _set(form, chunk)
                    t = time.perf_counter()
                    exe = encbatch._all_batch_compact_fn(
                        cfg.reject_factor, caps).lower(*args).compile()
                    comp_s = time.perf_counter() - t
                    ma = exe.memory_analysis()
                    mem = {k: int(getattr(ma, k + "_size_in_bytes", 0))
                           for k in ("argument", "output", "temp")}
                    out = np.asarray(exe(*args))
                    if want is None:
                        want = out
                    if not np.array_equal(out, want):
                        raise SystemExit(f"{name}: output differs from "
                                         f"the first variant")
                    runs[name] = (exe, args)
                    res["variants"][name] = {"compile_s": round(comp_s, 2),
                                             "bytes": mem, "ms": []}
                    log(f"{name}: compiled in {comp_s:.2f}s, bytes {mem}")
        order = list(runs) + list(reversed(runs))
        for name in order:
            exe, args = runs[name]
            for _ in range(a.reps):
                t = time.perf_counter()
                exe(*args).block_until_ready()
                res["variants"][name]["ms"].append(
                    round((time.perf_counter() - t) * 1e3, 3))
        for name, v in res["variants"].items():
            ms = sorted(v["ms"])
            log(f"{name}: min {ms[0]:.3f} ms, median "
                f"{ms[len(ms) // 2]:.3f} ms over {len(ms)} runs")

        if a.e2e:
            res["e2e_s"] = {f: [] for f in forms}
            for form in forms + list(reversed(forms)):
                _set(form, chunk0)
                encbatch._CAP_STATE.clear()
                encbatch.encode_corpus(corpus, bank, batch_size=8)
                t = time.perf_counter()
                encbatch.encode_corpus(corpus, bank, batch_size=8)
                dt = time.perf_counter() - t
                res["e2e_s"][form].append(round(dt, 3))
                log(f"encode_corpus 96 x 512^2, {form}: {dt:.3f}s warm")
    finally:
        jax_scoring._kernel_scoring = kernel_scoring
        jax_scoring.VALUES_CHUNK_PX = chunk0
        if a.out:
            path = pathlib.Path(a.out)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
