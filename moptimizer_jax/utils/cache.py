"""Persistent XLA compilation cache.

A SLAM front-end or a BA service pays XLA compilation of a few large
programs (coarse pass, grid build, fused build+solve, the dense BA step)
before its first result. The shapes are stable across runs, so the
executables are reusable: with the cache on, a process restart reloads them
instead of compiling again.

Opt-in (libraries should not write to disk unasked): call
``enable_persistent_cache()`` early, before the first jit execution.
bench.py, chip_smoke.py and the benchmark scripts do. The directory is
``JAX_COMPILATION_CACHE_DIR`` where that is set, and otherwise one fixed
directory inside the checkout (``<repo>/.jax_cache``, listed in
.gitignore): the cache is keyed on its path, so the path must not move.
"""

import os
import pathlib

DEFAULT_DIR = str(pathlib.Path(__file__).resolve().parents[2] / ".jax_cache")


def cache_dir():
    """The directory the persistent cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache(min_compile_seconds=1.0):
    """Point JAX's persistent compilation cache at ``cache_dir()`` (created
    if needed). Idempotent; returns the directory used.

    min_compile_seconds: only programs whose compile took at least this long
    are persisted — keeps the cache to the expensive programs (the LM
    solves, grid builds, BA steps) instead of thousands of trivial ops.
    """
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_seconds)
    )
    return path
