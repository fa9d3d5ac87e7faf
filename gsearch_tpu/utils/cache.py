"""Persistent XLA compilation cache setup (used by the CLI, bench and tests).

`JAX_COMPILATION_CACHE_DIR`, when set, is the cache and no other directory
is configured.  Otherwise the cache lives at a fixed directory inside the
checkout (`.jax_cache/`, git-ignored), so repeated runs from one checkout
reuse each compiled program.
"""

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")
_DONE = False


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Point JAX's persistent cache at cache_dir(); returns the directory."""
    global _DONE
    path = cache_dir()
    if _DONE:
        return path
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _DONE = True
    return path
