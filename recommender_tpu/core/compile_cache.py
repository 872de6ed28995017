"""Persistent XLA compilation cache placement.

Every entry point (the CLIs, ``bench.py``, ``chip_smoke.py``) calls
``enable_compile_cache()`` before its first compile, so a second run of the
same program on the same machine loads its executables instead of
compiling them again.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set here.
* Otherwise the cache lives at ``<repo root>/.jax_cache`` — a fixed path
  inside the checkout (the path is part of the cache key, so a moving
  directory would never hit), listed in ``.gitignore``.

JAX decides whether to use the cache at its first compile in a process, so
a call after that has no effect for the rest of the process.
"""
from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
