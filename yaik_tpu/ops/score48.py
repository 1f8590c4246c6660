"""The encoder's 48-pattern scoring as one Pallas kernel on the Triton route.

    sums[t, e, n] = sum_{p alive} min_k || c[t, p] - Q[e, n, k] ||^2

(EncoderContext.cpp:6421-6423 hot loop 2; jax_scoring.tile3d_score_device
is the plain XLA form and the reference). XLA cannot fuse the min-over-8-
points and the masked tile sum into a matrix product's epilogue, so the
plain form runs the [T, P, E, 48, 8, 3] differences elementwise. Here the
squared distance is ONE bf16 tensor-core product per scoring point:

    x = [c0, c1, c2, |c|^2 >> 6, |c|^2 & 63, 64, 1, 0 ...]      (K = 16)
    q = [-2q0, -2q1, -2q2, 64, 1, |q|^2 >> 6, |q|^2 & 63, 0 ...]
    x . q = |c|^2 - 2 c.q + |q|^2

Every operand is an integer <= 186, so bf16 holds it exactly, and every
partial sum stays below 2^24, so the f32 accumulation is exact in any
order. A dead pixel's row is all zero, which makes its distance 0 for
every pattern: that is the masked sum. The min over the 8 points and the
sum over each tile's pixels run on the product in registers; only the
[tiles, E*48] sums are written.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

K = 16          # contraction width: 7 used, padded to the bf16 MMA's K
ROWS = 128      # pixel rows per block: 128 // P tiles
COLS = 64       # patterns per block (E*48 is a multiple of 48)


def _kernel(P, x_ref, q_ref, o_ref):
    x = x_ref[...]                                       # [ROWS, K] bf16
    m = None
    for k in range(8):
        d = pl.dot(x, q_ref[k * K:(k + 1) * K, :])       # [ROWS, COLS] f32
        m = d if m is None else jnp.minimum(m, d)
    o_ref[...] = m.reshape(ROWS // P, P, COLS).sum(axis=1).astype(jnp.int32)


def _operands(c, alive, qpts):
    """x [T, P, K] and q [8*K, E*48] in the kernel's exact bf16 form."""
    c = c.astype(jnp.int32)
    c2 = (c * c).sum(-1, keepdims=True)
    one = jnp.ones_like(c2)
    x = jnp.concatenate(
        [c, c2 >> 6, c2 & 63, 64 * one, one,
         jnp.zeros(c.shape[:2] + (K - 7,), jnp.int32)], axis=-1)
    x = jnp.where(alive[:, :, None], x, 0).astype(jnp.bfloat16)
    E = qpts.shape[0]
    q = qpts.astype(jnp.int32).transpose(2, 0, 1, 3).reshape(8, E * 48, 3)
    q2 = (q * q).sum(-1, keepdims=True)
    qone = jnp.ones_like(q2)
    qm = jnp.concatenate(
        [-2 * q, 64 * qone, qone, q2 >> 6, q2 & 63,
         jnp.zeros((8, E * 48, K - 7), jnp.int32)], axis=-1)    # [8, n, K]
    return x, qm.transpose(0, 2, 1).reshape(8 * K, E * 48).astype(
        jnp.bfloat16)


@partial(jax.jit, static_argnames=("interpret",))
def score48(c, alive, qpts, interpret=False):
    """c [T, P, 3] i32 in 0..63; alive [T, P] bool; qpts [E, 48, 8, 3] i32.
    Returns sums [T, E, 48] i32 == where(alive, min_k |c-q|^2, 0).sum(P).
    P (the tile's pixel count) must divide ROWS."""
    T, P, _ = c.shape
    E = qpts.shape[0]
    if ROWS % P:
        raise ValueError(f"tile size {P} does not divide {ROWS} rows")
    n = E * 48
    npad = -(-n // COLS) * COLS
    tb = ROWS // P
    tpad = -(-T // tb) * tb
    x, q = _operands(c, alive, qpts)
    x = jnp.pad(x, ((0, tpad - T), (0, 0), (0, 0))).reshape(tpad * P, K)
    q = jnp.pad(q, ((0, 0), (0, npad - n)))
    # under shard_map the sums vary over every mesh axis the inputs vary
    # over (the tiles' shard axis); the replicated patterns are cast to
    # the same axes so that the product's operands agree
    vma = jax.typeof(x).vma | jax.typeof(q).vma
    x, q = (jax.lax.pcast(v, tuple(vma - jax.typeof(v).vma), to="varying")
            if vma - jax.typeof(v).vma else v for v in (x, q))
    out = pl.pallas_call(
        partial(_kernel, P),
        out_shape=jax.ShapeDtypeStruct((tpad, npad), jnp.int32, vma=vma),
        grid=(tpad // tb, npad // COLS),
        in_specs=[pl.BlockSpec((ROWS, K), lambda i, j: (i, 0)),
                  pl.BlockSpec((8 * K, COLS), lambda i, j: (0, j))],
        out_specs=pl.BlockSpec((tb, COLS), lambda i, j: (i, j)),
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="score48",
    )(x, q)
    return out[:T, :n].reshape(T, E, 48)
