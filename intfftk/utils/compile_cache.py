"""Persistent compilation cache shared by the scripts that drive the chip.

``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and wins:
nothing is set in code.  Otherwise the cache lives at ``<repo>/.jax_cache``
(listed in ``.gitignore``) — a fixed path, because the path is part of the
cache key, so a second run of the same script finds its executables.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory ``enable_compile_cache`` uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Turn the persistent cache on before the first compile; returns its
    directory."""
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return cache_dir()
