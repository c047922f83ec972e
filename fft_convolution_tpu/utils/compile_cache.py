"""Where the entry scripts keep JAX's persistent compilation cache.

The cache directory is part of what makes a cached executable found
again, so it is a fixed path: ``JAX_COMPILATION_CACHE_DIR`` when the
environment sets it (JAX reads that variable itself), otherwise
``.jax_cache`` at the root of the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import os
import pathlib

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.
    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is set."""
    env_dir = os.environ.get(ENV_VAR)
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
