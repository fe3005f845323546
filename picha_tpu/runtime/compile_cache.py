"""Persistent XLA compilation cache bootstrap.

The batched JPEG graphs (the device Huffman decoder and encoder above
all) take tens of seconds to compile. JAX's persistent compilation
cache turns that into a one-time cost shared across processes.

Contract: where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
itself and this module sets nothing. Otherwise the cache lives at the
fixed ``<repo>/.jax_cache``: the directory is part of the cache's key,
so a path that moves between runs (a temporary directory) never hits.

The pipelines call :func:`enable` on import; it is idempotent.
"""
from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"
ENV = "JAX_COMPILATION_CACHE_DIR"


def cache_dir() -> pathlib.Path:
    """The directory the persistent cache uses in this process."""
    return pathlib.Path(os.environ.get(ENV) or DEFAULT_DIR)


def enable() -> pathlib.Path:
    """Point JAX's persistent compilation cache at :func:`cache_dir`
    unless the environment already does; returns the directory."""
    if os.environ.get(ENV):
        return cache_dir()
    import jax

    if not jax.config.jax_compilation_cache_dir:
        DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return pathlib.Path(jax.config.jax_compilation_cache_dir)
