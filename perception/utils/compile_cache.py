"""Where JAX keeps its persistent compilation cache.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module changes nothing. Otherwise the cache goes to ``.jax_cache`` at
the root of the checkout: a fixed path (git-ignored), so a later run of
the same code finds what an earlier one compiled.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def configure_compile_cache() -> str:
    """Enable the persistent cache before the first compile; returns its
    directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE)
    return CHECKOUT_CACHE
