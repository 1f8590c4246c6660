"""chip_smoke.py: refuses to report anything without a GPU or outside the
repository, and its exactness reference agrees with the device
normalizations here on the CPU for every k <= d <= 255."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np

import jax
import jax.numpy as jnp

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(res):
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    if lines:
        try:
            assert not json.loads(lines[-1]).get("ok")
        except ValueError:
            pass


def test_chip_smoke_refuses_cpu():
    res = _run(REPO, REPO / "chip_smoke.py")
    _no_result(res)
    assert "no GPU" in res.stderr


def test_chip_smoke_needs_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _no_result(_run(tmp_path, tmp_path / "chip_smoke.py"))


def test_norm_coords_match_host_reference():
    import chip_smoke
    from yaik_tpu.encoder.jax_scoring import _norm_coords
    D = np.arange(256, dtype=np.int32)
    K = np.tile(np.arange(256, dtype=np.int32), (256, 1))
    valid = K <= D[:, None]
    got = jax.jit(_norm_coords)(jnp.asarray(K), jnp.asarray(D))
    for g, w in zip(got, chip_smoke.norm_reference(K, D)):
        assert np.array_equal(np.asarray(g)[valid], w[valid])


def test_score_reference_matches_plain_form():
    import chip_smoke
    from yaik_tpu.encoder.jax_scoring import tile3d_score_device
    rng = np.random.default_rng(3)
    c = rng.integers(0, 64, (40, 16, 3)).astype(np.int32)
    alive = rng.random((40, 16)) < 0.7
    q = rng.integers(0, 64, (2, 48, 8, 3)).astype(np.int32)
    want = np.asarray(tile3d_score_device(jnp.asarray(c), jnp.asarray(alive),
                                          jnp.asarray(q)))
    assert np.array_equal(chip_smoke.score_reference(c, alive, q, rows=64),
                          want)
