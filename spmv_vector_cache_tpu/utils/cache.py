"""Persistent compilation cache location, chosen in one place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and this
module sets nothing.  Otherwise the cache lives in ``.jax_cache`` at the
root of the checkout (listed in ``.gitignore``): a fixed path, so a later
process finds what an earlier one compiled.
"""

from __future__ import annotations

import os

#: the checkout root: the directory that holds the package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
