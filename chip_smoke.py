#!/usr/bin/env python3
"""Smoke test of the decode and encode paths on one GPU (with --four, of
the mesh paths on four GPUs).

Drives the entry points users call, at the sizes they run, and checks every
result against the repository's own references. Phases, in order:

  device   the first JAX device is a GPU - there is no CPU fallback
  kernels  ops.score48 as compiled for the card == the plain form
           (score_reference, numpy twin of jax_scoring.tile3d_score_device)
           at the bank's real width
  pack     decode_corpus: a 128-stream pack of 512^2 textures (five chunk
           families: gradient, 3D-LUT, 2DTL, UCOL/SMAP overlay, 1D,
           RGBA) in ONE batch of 128 == the reference-decoded goldens;
           then an all-RGBA batch through the device alpha stage
  still4k  decode_spatial of a 3840x2160 stream on one card == the host
           decoder
  encode   encode_corpus: 96 images of 512^2 at batch 8; host-decoded pixel
           checksums == tests/fixtures/bench_encode_golden.json, and two
           streams byte-equal to encode_image(engine="host")
  exact    the device normalizations (jax_scoring._norm_coords) == numpy
           float32 on the host for every k <= d <= 255

--four runs only the mesh phases, on a flat 4-device "data" mesh: the
128-stream pack through decode_corpus(mesh=), the 96-image
encode_corpus(mesh=), each compared with its one-card result (per-device
shard shapes and peak memory printed), and the seven axes of
__graft_entry__.dryrun_multichip.

Any failure raises and the process exits non-zero. The last line of stdout
is one JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.

Usage: python chip_smoke.py [--four]
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yaik_tpu.utils import compile_cache, png  # noqa: E402

FIX = REPO / "tests" / "fixtures"
PACK_NAMES = ("img512", "img512b", "bench_rgba512", "bench_2d512",
              "bench_ucol512")
PACK = 128            # streams in the pack, all in one batch
ENC_IMAGES = 96
ENC_BATCH = 8


class SmokeFailure(Exception):
    pass


def check(ok, what):
    if not ok:
        raise SmokeFailure(what)


def phase(name):
    """Decorator: print the phase's wall time after it returns."""
    def wrap(fn):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            print(f"phase {name}: ok in {time.perf_counter() - t0:.1f}s",
                  flush=True)
            return out
        return run
    return wrap


def _luts():
    from yaik_tpu.decoder import api
    return api.assign_lut((FIX / "LutFile.lut").read_bytes(),
                          (FIX / "LutFile2D.lut").read_bytes())


def _pack():
    streams = [(FIX / f"{n}.yaik").read_bytes() for n in PACK_NAMES]
    golds = [np.load(FIX / f"{n}.dec.npz")["rgb"] for n in PACK_NAMES]
    k = len(PACK_NAMES)
    return ([streams[i % k] for i in range(PACK)],
            [golds[i % k] for i in range(PACK)])


def _enc_corpus():
    from bench import _enc_variant
    base = [png.read_png(FIX / f"{n}.png", rgb=True)
            for n in ("img512", "img512b")]
    return [_enc_variant(base[i % 2], i) for i in range(ENC_IMAGES)]


def _bank():
    from yaik_tpu.encoder import bank as bankmod
    return bankmod.load_bank(str(FIX / "Bank3D"))


def info_lines():
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"unavailable ({e})"
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"jax {jax.__version__} devices: {jax.devices()}", flush=True)
    from yaik_tpu import native
    from yaik_tpu.entropy import zstd_backend
    print(f"native host library: "
          f"{'loaded' if native.available() else 'not loaded'}; "
          f"reference zstd 1.3.4: {zstd_backend.IS_REFERENCE_ZSTD}",
          flush=True)


@phase("device")
def phase_device(n):
    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is {devs[0].platform}")
    check(len(devs) >= n, f"need {n} GPUs, found {len(devs)}")


def score_reference(c, alive, qpts, rows=1024):
    """numpy twin of jax_scoring.tile3d_score_device, in tile chunks (on
    the card, XLA's compile of the plain form's unchunked [T, P, E, 48,
    8, 3] reduction takes minutes)."""
    out = []
    for i in range(0, c.shape[0], max(1, rows // c.shape[1])):
        cc, al = c[i:i + rows // c.shape[1]], alive[i:i + rows // c.shape[1]]
        d = cc[:, :, None, None, None, :] - qpts[None, None]
        dist = (d * d).sum(-1).min(-1)
        out.append(np.where(al[:, :, None, None], dist, 0).sum(1))
    return np.concatenate(out).astype(np.int32)


@phase("kernels")
def phase_kernels():
    from yaik_tpu.encoder import device_pipeline as devp
    from yaik_tpu.ops.score48 import score48
    qpts = devp.bank_device_tables(_bank())[0]
    rng = np.random.default_rng(0)
    for T, P in ((2048, 16), (256, 128)):
        c = rng.integers(0, 64, (T, P, 3)).astype(np.int32)
        alive = rng.random((T, P)) < 0.8
        got = np.asarray(score48(jnp.asarray(c), jnp.asarray(alive), qpts))
        want = score_reference(c, alive, np.asarray(qpts))
        check(np.array_equal(got, want),
              f"score48 != plain form at T={T} P={P}")
        print(f"  score48 [{T}, {P}] x E={qpts.shape[0]}: equal",
              flush=True)


@phase("pack")
def phase_pack(lut):
    from yaik_tpu.parallel.batch import decode_corpus
    streams, golds = _pack()
    out = decode_corpus(streams, lut, batch_size=PACK)
    bad = [i for i, (o, g) in enumerate(zip(out, golds))
           if not np.array_equal(o, g)]
    check(not bad, f"pack decode: {len(bad)} of {PACK} images differ "
                   f"(first {bad[:5]})")
    rgba = (FIX / "bench_rgba512.yaik").read_bytes()
    gold = np.load(FIX / "bench_rgba512.dec.npz")["rgb"]
    out_a = decode_corpus([rgba] * 8, lut, batch_size=8)
    check(all(np.array_equal(o, gold) for o in out_a),
          "device alpha batch differs")
    print(f"  {PACK} streams x 512^2 in one batch: pixel-equal; "
          f"RGBA batch of 8 (device alpha): pixel-equal", flush=True)
    return out


@phase("still4k")
def phase_still4k(lut):
    from yaik_tpu.decoder import reference as refdec
    from yaik_tpu.parallel.batch import decode_spatial
    stream = (FIX / "bench_4k.yaik").read_bytes()
    got = decode_spatial(stream, lut, n_bands=1)
    want = refdec.decode(stream, lut.expanded)
    check(got.shape == want.shape and np.array_equal(got, want),
          "4K still differs from the host decoder")
    print(f"  {got.shape[1]}x{got.shape[0]}: pixel-equal", flush=True)


def _pix_checksum(rgb):
    from bench import _checksum_weights
    h, w, c = rgb.shape
    return int((rgb.astype(np.uint64) * _checksum_weights(h, w, c)).sum()
               % (1 << 32))


@phase("encode")
def phase_encode(lut):
    from yaik_tpu.decoder import reference as refdec
    from yaik_tpu.encoder.batch import encode_corpus
    from yaik_tpu.encoder.context import encode_image
    bank = _bank()
    corpus = _enc_corpus()
    streams = encode_corpus(corpus, bank, batch_size=ENC_BATCH)
    gold = json.loads((FIX / "bench_encode_golden.json").read_text())
    bad = [i for i, st in enumerate(streams)
           if _pix_checksum(refdec.decode(st, lut.expanded))
           != gold["pix"][i]]
    check(not bad, f"encode: {len(bad)} of {ENC_IMAGES} decoded checksums "
                   f"differ (first {bad[:5]})")
    for i in (0, 1):
        check(streams[i] == encode_image(corpus[i], bank, engine="host"),
              f"encode: image {i} device bytes != host engine bytes")
    print(f"  {ENC_IMAGES} images at batch {ENC_BATCH}: decoded checksums "
          f"equal the golden; images 0, 1 byte-equal to the host engine",
          flush=True)
    return streams


def norm_reference(K, D):
    """numpy float32 on the host: the chains _norm_coords replaces."""
    nvec = np.where(D > 0, (1 << 20) // np.maximum(D, 1), 0)
    cc = ((K * nvec[:, None]).astype(np.float32) / np.float32(1 << 20)
          * np.float32(63)).astype(np.int64)
    rel = K.astype(np.float32)
    Dc = D[:, None].astype(np.float32)
    rel = np.where(D[:, None] > 0, rel / np.maximum(Dc, 1), rel)
    rel = rel * np.float32(63.0)
    return cc, rel.astype(np.int64), (np.float32(63.0) - rel).astype(
        np.int64)


@phase("exact")
def phase_exact():
    from yaik_tpu.encoder.jax_scoring import _norm_coords
    D = np.arange(256, dtype=np.int32)
    K = np.tile(np.arange(256, dtype=np.int32), (256, 1))
    valid = K <= D[:, None]
    got = [np.asarray(x) for x in jax.jit(_norm_coords)(jnp.asarray(K),
                                                        jnp.asarray(D))]
    for name, g, w in zip(("cc", "ac", "bc"), got, norm_reference(K, D)):
        nbad = int((g != w)[valid].sum())
        check(nbad == 0, f"normalization {name}: {nbad} of "
                         f"{int(valid.sum())} (k, d) pairs differ")
    print(f"  cc, ac, bc equal for all {int(valid.sum())} pairs k <= d "
          f"<= 255", flush=True)


def _shards(name, arr):
    print(f"  {name} shards: "
          + ", ".join(f"dev{s.device.id}:{tuple(s.data.shape)}"
                      for s in arr.addressable_shards), flush=True)


def _peak_mem(mesh):
    print("  peak bytes in use: " + ", ".join(
        f"dev{d.id}:{(d.memory_stats() or {}).get('peak_bytes_in_use')}"
        for d in mesh.devices.flat), flush=True)


@phase("mesh-dryrun")
def phase_mesh_dryrun():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(4)


@phase("mesh-pack")
def phase_mesh_pack(lut, mesh):
    from yaik_tpu.decoder import jax_engine, planner
    from yaik_tpu.parallel import batch as par
    streams, golds = _pack()
    one = par.decode_corpus(streams, lut, batch_size=PACK)
    four = par.decode_corpus(streams, lut, batch_size=PACK, mesh=mesh)
    check(all(np.array_equal(a, b) for a, b in zip(one, four)),
          "mesh pack decode differs from one card")
    check(all(np.array_equal(a, g) for a, g in zip(four, golds)),
          "mesh pack decode differs from the goldens")
    uniq = [planner.build_plan(s, lut.expanded, lut.expanded2d)
            for s in streams[:len(PACK_NAMES)]]
    plans = [uniq[i % len(uniq)] for i in range(PACK)]
    layout = jax_engine.batch_layout(plans, lut.expanded)
    args = [jax_engine.plan_to_device_args(p, lut.expanded, lut.expanded2d,
                                           layout=layout)[2][:-1]
            for p in plans]
    tab = jax_engine.lut_device_table(lut.expanded)[0]
    _, b_args = par._put_sharded(tab, par._stack_args(args), mesh)
    _shards("decode batch (gradient accepts, pass 0)", b_args[0][0])
    _peak_mem(mesh)
    print(f"  {PACK} streams over {mesh.devices.size} GPUs: equal to one "
          f"card and to the goldens", flush=True)


@phase("mesh-encode")
def phase_mesh_encode(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    from yaik_tpu.encoder.batch import encode_corpus
    bank = _bank()
    corpus = _enc_corpus()
    one = encode_corpus(corpus, bank, batch_size=ENC_BATCH)
    four = encode_corpus(corpus, bank, batch_size=ENC_BATCH, mesh=mesh)
    check(one == four, "mesh encode differs from one card")
    planes = np.stack([im.transpose(2, 0, 1) for im in corpus[:ENC_BATCH]])
    _shards("encode batch (planes)",
            jax.device_put(planes, NamedSharding(mesh, P("data"))))
    _peak_mem(mesh)
    print(f"  {ENC_IMAGES} images over {mesh.devices.size} GPUs: byte-equal "
          f"to one card", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU mesh phases")
    args = ap.parse_args()
    n = 4 if args.four else 1

    info_lines()
    phase_device(n)
    compile_cache.configure()
    lut = _luts()
    if args.four:
        from yaik_tpu.parallel.batch import data_mesh
        mesh = data_mesh(4)
        phase_mesh_pack(lut, mesh)
        phase_mesh_encode(mesh)
        phase_mesh_dryrun()
    else:
        phase_kernels()
        phase_pack(lut)
        phase_still4k(lut)
        phase_encode(lut)
        phase_exact()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
