"""Persistent XLA compilation cache.

Every fresh process compiles the HTM step again. JAX's persistent
compilation cache serializes executables to disk, keyed by (HLO,
compile options, backend), so a later process running the same program
loads them instead.

Where the cache lives:

  * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads that directory itself,
    and this module sets no other.
  * otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``). The
    path is fixed — never a temporary directory, a process id or a
    timestamp — so a later run from the same checkout finds the entries.

Call it once, before the first jit dispatch:

    from bithtm_tpu.utils.compile_cache import enable_compilation_cache
    enable_compilation_cache()

`example.py`, `bench.py` and `chip_smoke.py` call it at start-up.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)


def cache_dir(environ=os.environ) -> str:
    """The directory the cache uses under ``environ``: the variable's
    value when set (and non-empty), else the fixed in-checkout path."""
    return environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compilation_cache() -> str:
    """Enable JAX's persistent compilation cache (see the module
    docstring for where). Returns the directory used.

    Thresholds are zeroed so every program in the library caches, not
    just the slowest: the win is a warm start in every later process.
    """
    import jax

    d = cache_dir()
    if not os.environ.get(ENV_VAR):
        os.makedirs(d, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
