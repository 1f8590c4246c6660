import os

# The suite runs on the CPU backend, with a virtual 8-device mesh for the
# sharding tests. Tests that need the card carry the `gpu` marker and run
# there with JAX_PLATFORMS=cuda (see pytest.ini); everywhere else they skip.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402  (must precede any yaik_tpu jax use)

import pathlib

# Persist XLA compilations across pytest runs: the fast tier's cost is
# dominated by CPU-backend jit compiles that are identical run to run.
# Set via jax.config (NOT os.environ) so clean-env subprocesses like
# tests/jax_driver.py do not inherit it: their CPU client has different
# machine flags and XLA warns (and may SIGILL) loading the other profile's
# AOT entries.
_CACHE = pathlib.Path(__file__).parent / ".jax_cache"
jax.config.update("jax_compilation_cache_dir", str(_CACHE))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np
import pytest

FIXTURES = pathlib.Path(__file__).parent / "fixtures"


@pytest.fixture(scope="session")
def lut_bytes():
    return (FIXTURES / "LutFile.lut").read_bytes()


def fixture_names():
    # plain-stem streams only: dotted stems (img64.ucol, corr2d128.2d) are
    # special-pass goldens with their own test files. bench_* streams come
    # from OUR encoder (bench-lane inputs, tools/gen_bench_family_fixtures.py)
    # and are covered by tests/test_bench_family_golden.py, not the
    # reference-encoder golden set.
    return sorted(p.stem for p in FIXTURES.glob("*.yaik")
                  if "." not in p.stem and not p.stem.startswith("bench_"))


def fixture_params(slow_when=lambda name: "512" in name):
    """fixture_names with pytest.mark.slow applied to the big images (the
    512^2 encodes dominate the default suite; the fast tier skips them)."""
    return [pytest.param(n, marks=pytest.mark.slow) if slow_when(n)
            else n for n in fixture_names()]


@pytest.fixture(scope="session")
def golden():
    def load(name):
        stream = (FIXTURES / f"{name}.yaik").read_bytes()
        rgb = np.load(FIXTURES / f"{name}.dec.npz")["rgb"]
        return stream, rgb
    return load
