"""JAX's persistent compilation cache for the entry points.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself
and nothing else is configured here). Otherwise the cache lives at a
fixed path inside the checkout, ``<repo>/.jax_cache`` (listed in
.gitignore), so a second run of any entry point skips recompiling the
frame step.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    DEFAULT_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)
