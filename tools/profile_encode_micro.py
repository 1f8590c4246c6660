#!/usr/bin/env python3
"""Split the encoder device time: gradient bundle vs 3D (score / values).

B=8 512^2, E=12, live backend.
"""
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from yaik_tpu.encoder import bank as bankmod  # noqa: E402
from yaik_tpu.encoder import batch as encbatch  # noqa: E402
from yaik_tpu.encoder import device_pipeline as devp  # noqa: E402
from yaik_tpu.encoder import jax_scoring  # noqa: E402
from yaik_tpu.ops.score48 import score48  # noqa: E402

FIX = pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures"
B, SIZE = 8, 512


def timed(label, fn, *args, reps=3):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(fn(*args))
    dt = (time.perf_counter() - t0) / reps
    print(f"{label:40s} {1e3*dt:8.1f} ms", flush=True)


def main():
    print("backend:", jax.devices()[0].platform, flush=True)
    bank = bankmod.load_bank(str(FIX / "Bank3D"))
    qpts, pts, factors = devp.bank_device_tables(bank)
    rng = np.random.default_rng(0)

    planes8 = jnp.asarray(rng.integers(0, 256, (B, 3, SIZE, SIZE), np.uint8))
    claims = jnp.zeros((B, 3, SIZE, SIZE), bool)

    gfn = encbatch._grad_batch_fn(3)
    timed("gradient bundle (7 passes, B=8)", gfn, planes8)

    t3fn = jax.jit(lambda p, c: devp._tile3d_all.__wrapped__(
        p.astype(jnp.int32), c, qpts, pts, factors))
    timed("3D bundle (6 passes, B=8)", t3fn, planes8, claims)

    for (sx, sy) in [(3, 3), (2, 2)]:
        tw, th = 1 << sx, 1 << sy
        T = (SIZE // th) * (SIZE // tw) * B
        P = tw * th
        E = int(qpts.shape[0])
        c = jnp.asarray(rng.integers(0, 64, (T, P, 3), np.int32))
        alive = jnp.asarray(rng.random((T, P)) < 0.5)
        tiles = jnp.asarray(rng.integers(0, 256, (T, P, 3), np.int32))
        a_c = jnp.asarray(rng.integers(0, 64, (T, P, 3), np.int32))
        b_c = 63 - a_c
        mode48 = jnp.asarray(rng.integers(0, 48, (T, E), np.int32))
        mn = jnp.asarray(rng.integers(0, 128, (T, 3), np.int32))
        d = jnp.asarray(rng.integers(1, 128, (T, 3), np.int32))

        print(f"pass {tw}x{th}: T={T} P={P} E={E}")
        timed("  score48 (Triton route)", jax.jit(
            lambda c, a: score48(c, a, qpts)), c, alive)

        tc = max(1, jax_scoring.VALUES_CHUNK_PX // P)
        pad = (-T) % tc
        def mk_vals():
            def f(tiles, alive, a_c, b_c, mode48, mn, d):
                def padt(x):
                    return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))
                nch = (T + pad) // tc
                return jax.lax.map(
                    lambda i: jax_scoring.tile3d_values_device.__wrapped__(
                        *(jax.lax.dynamic_slice_in_dim(padt(v), i * tc, tc)
                          for v in (tiles, alive, a_c, b_c, mode48, mn, d)),
                        pts, factors),
                    jnp.arange(nch))
            return jax.jit(f)
        timed("  values (chunked lax.map)", mk_vals(),
              tiles, alive, a_c, b_c, mode48, mn, d)


if __name__ == "__main__":
    main()
