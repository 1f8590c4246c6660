"""JAX decode engine vs golden fixtures, on a clean-env CPU subprocess
(8 virtual devices) that shares no jit cache with the suite."""
import os
import pathlib
import subprocess
import sys

import pytest


def _run_driver(extra_args=(), timeout=1800):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8").strip()
    driver = pathlib.Path(__file__).parent / "jax_driver.py"
    res = subprocess.run([sys.executable, str(driver), *extra_args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "ALL OK" in res.stdout


def test_jax_engine_smoke():
    """Fast tier: one compiled jax decode, bit-exact vs the golden."""
    _run_driver(["--fast"], timeout=600)


@pytest.mark.slow
@pytest.mark.nightly
def test_jax_engine_subprocess():
    """Nightly tier (412 s: the clean-env subprocess deliberately shares
    no jit cache): engine matrix, mesh decode, spatial bands, corpus
    pipeline, multi-chunk parallel surfaces, dryrun entry points. The
    fast-tier smoke above covers the same driver single-path."""
    _run_driver()
