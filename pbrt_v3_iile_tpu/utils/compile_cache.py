"""JAX persistent compilation cache location.

One rule for every entry point (the CLI, bench.py, chip_smoke.py): when
JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing else
is set; otherwise the cache lives in `.jax_cache` at the root of the
checkout (listed in .gitignore), a fixed path so that later runs from
the same checkout hit it.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable(checkout: str = CHECKOUT) -> str:
    """Turn the persistent cache on; returns its directory."""
    path = os.environ.get(ENV)
    if path:
        return path
    import jax

    path = os.path.join(checkout, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
