"""Persistent XLA compilation cache.

Compiling the control-flow-heavy programs (the EKF measurement scan, the
waypoint and SLAM loops, the RBPF step) takes seconds each; the persistent
cache keys serialized executables by HLO hash, so every later process
loads them in milliseconds. Demos, benches and ``chip_smoke.py`` call
:func:`enable` first.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and nothing here overrides it); otherwise the fixed
``.jax_cache`` directory of this checkout, which ``.gitignore`` lists. The
path is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`enable` uses."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable() -> str:
    """Idempotently enable the persistent compilation cache; returns its
    directory."""
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    # Size gating must be disabled explicitly or small entries are not
    # written.
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
