"""Placement of JAX's persistent compilation cache."""

import os

import jax

from perception.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _with_restored_config(fn):
    before = jax.config.jax_compilation_cache_dir
    try:
        return fn()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_env_variable_wins_and_nothing_is_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    got = _with_restored_config(compile_cache.configure_compile_cache)
    assert got == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_unset_env_uses_fixed_path_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)

    def configure():
        path = compile_cache.configure_compile_cache()
        return path, jax.config.jax_compilation_cache_dir

    path, configured = _with_restored_config(configure)
    assert path == configured == os.path.join(REPO, ".jax_cache")
    # Fixed: the same on every call, never a temporary name.
    assert _with_restored_config(compile_cache.configure_compile_cache) == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
