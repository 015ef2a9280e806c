"""JAX's persistent compilation cache, kept at one fixed place.

Entry points (``chip_smoke.py``, ``bench.py``, ``__graft_entry__.py`` and
the scripts) call :func:`enable_compile_cache` before their first compile,
so a second run with the same shapes loads compiled programs instead of
compiling them again. ``$JAX_COMPILATION_CACHE_DIR`` wins when it is set;
otherwise the cache lives in ``.jax_cache/`` at the root of the checkout
(listed in ``.gitignore``). No other cache path is set anywhere in code.
"""

from __future__ import annotations

import os

__all__ = ["cache_dir", "enable_compile_cache"]

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cache_dir() -> str:
    """The cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or ``.jax_cache/``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
