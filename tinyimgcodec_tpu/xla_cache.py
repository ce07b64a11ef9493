"""Persistent XLA compilation cache setup.

The double-float transform graphs are large; first compiles take tens of
seconds.  Every pipeline entry point calls :func:`ensure_cache` before its
first jit so compiles are shared across processes.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives at a fixed path
inside the checkout (``.xla_cache/``, listed in ``.gitignore``): the path
is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".xla_cache",
)

_done = False


def ensure_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    try:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            os.makedirs(CACHE_DIR, exist_ok=True)
            jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    except (RuntimeError, OSError):
        pass  # already configured or read-only checkout: non-fatal
