"""Compile-cache placement of the launchers (yaik_tpu.utils.compile_cache):
JAX_COMPILATION_CACHE_DIR wins untouched; otherwise one fixed directory of
the checkout."""
import jax

from yaik_tpu.utils import compile_cache


def test_env_dir_is_left_to_jax(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.configure() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == old
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_default_dir_is_fixed_in_checkout(monkeypatch):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.configure()
        assert got == jax.config.jax_compilation_cache_dir
        assert got == str(compile_cache.DEFAULT_DIR)
        assert (compile_cache.DEFAULT_DIR.parent / "chip_smoke.py").exists()
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
