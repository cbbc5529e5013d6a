"""Persistent XLA compilation cache shared by the program entry points.

``JAX_COMPILATION_CACHE_DIR``, when set, names the cache and nothing else
is configured (JAX reads the variable itself). Otherwise the cache lives at
``<checkout>/.jax_cache/``: a fixed path, so every run from the same
checkout finds the programs the previous run compiled.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_CHECKOUT, ".jax_cache")


def compilation_cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory: the environment's if set, else DEFAULT_DIR."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def setup_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at compilation_cache_dir()
    and return the directory. Call once, before the first compile."""
    import jax

    path = compilation_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
