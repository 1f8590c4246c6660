"""ops.score48, the Triton-route scoring kernel, against the plain XLA
form (jax_scoring.tile3d_score_device): in interpret mode here for every
tile size the encoder runs, and compiled on the card under the gpu
marker (chip_smoke.py's kernels phase runs the same comparison at the
bank's full width)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from yaik_tpu.encoder.jax_scoring import tile3d_score_device
from yaik_tpu.ops.score48 import score48


def _inputs(seed, T, P, E):
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 64, (T, P, 3)).astype(np.int32)
    c[0] = 63                                  # the largest distances
    alive = rng.random((T, P)) < 0.7
    alive[1] = False                           # an all-dead tile
    qpts = rng.integers(0, 64, (E, 48, 8, 3)).astype(np.int32)
    qpts[0, :, :, :] = 0
    return jnp.asarray(c), jnp.asarray(alive), jnp.asarray(qpts)


@pytest.mark.parametrize("P", [16, 32, 64, 128])
def test_score48_interpret_matches_plain(P):
    # T = 13 pads the tile axis to the block; E = 3 pads the pattern axis
    c, alive, qpts = _inputs(P, 13, P, 3)
    got = np.asarray(score48(c, alive, qpts, interpret=True))
    want = np.asarray(tile3d_score_device(c, alive, qpts))
    assert got.shape == (13, 3, 48)
    assert np.array_equal(got, want)


def test_score48_inside_shard_map():
    """The kernel as the mesh encode runs it: per-device shards of the
    tiles, replicated patterns. (Interpret mode's block loop carries no
    varying axes, so this numeric check runs without JAX's check; the
    test below traces the compiled form with the check on.)"""
    from jax.sharding import PartitionSpec as P
    c, alive, qpts = _inputs(2, 16, 16, 2)
    mesh = jax.make_mesh((4,), ("data",))
    f = jax.shard_map(lambda c, a, q: score48(c, a, q, interpret=True),
                      mesh=mesh, in_specs=(P("data"), P("data"), P()),
                      out_specs=P("data"), check_vma=False)
    got = np.asarray(jax.jit(f)(c, alive, qpts))
    assert np.array_equal(got, np.asarray(tile3d_score_device(c, alive,
                                                               qpts)))


def test_score48_declares_output_variance():
    """Under shard_map with the varying-axes check on (as the mesh encode
    runs), the Triton-route call types: its sums vary over the tiles'
    shard axis."""
    from jax.sharding import PartitionSpec as P
    c, alive, qpts = _inputs(3, 16, 16, 2)
    mesh = jax.make_mesh((4,), ("data",))
    seen = []

    def body(c, a, q):
        out = score48(c, a, q)
        seen.append(jax.typeof(out).vma)
        return out

    f = jax.shard_map(body, mesh=mesh, in_specs=(P("data"), P("data"), P()),
                      out_specs=P("data"))
    traced = jax.jit(f).trace(c, alive, qpts)
    assert seen == [frozenset({"data"})]
    assert traced.out_info.shape == (16, 2, 48)


def test_score48_rejects_tile_not_dividing_block():
    c, alive, qpts = _inputs(0, 4, 48, 1)
    with pytest.raises(ValueError):
        score48(c, alive, qpts, interpret=True)


@pytest.mark.gpu
def test_score48_compiled_on_card():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU: the Triton route compiles only there")
    c, alive, qpts = _inputs(1, 4096, 16, 12)
    got = np.asarray(score48(c, alive, qpts))
    assert np.array_equal(got, np.asarray(tile3d_score_device(c, alive,
                                                               qpts)))
