"""Persistent XLA compile cache for the launchers that run on the card
(bench.py, chip_smoke.py, tools/bench_*.py).

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here touches the setting. Otherwise the cache lives in ONE fixed,
git-ignored directory of the checkout: the path is part of the cache key,
so a directory that moved between runs would never hit.
"""
from __future__ import annotations

import os
import pathlib

import jax

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def configure() -> str:
    """Point JAX's persistent compile cache at its directory; returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
