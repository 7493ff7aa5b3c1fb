"""JAX's persistent compilation cache, in one place.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives in ``<repo>/.jax_cache`` (listed in
``.gitignore``), a fixed path, so that later runs from the same checkout
find what earlier ones compiled.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
