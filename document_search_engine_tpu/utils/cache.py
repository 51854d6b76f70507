"""Persistent XLA compilation cache for accelerator runs.

Compiled executables are kept in `$JAX_COMPILATION_CACHE_DIR` when that
is set (JAX reads the variable itself; nothing here overrides it), and
otherwise at one fixed path inside the checkout, `<repo>/.jax_cache`
(gitignored): the path is part of where a later process looks, so it
never depends on the home directory, a temporary name, a pid or a time.
Called by bench.py, chip_smoke.py, the CLI and the tools/ scripts
before any jit executes.

The cache stays off on a CPU backend. XLA:CPU serialized executables
embed the compile machine's ISA (avx512fp16, amx, ...); loading one on a
host without those features crashes, and CPU compiles are seconds
anyway.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ),
    ".jax_cache",
)


def cache_dir() -> str:
    """The cache directory a run uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> None:
    import jax

    plats = os.environ.get("JAX_PLATFORMS", "") or str(
        getattr(jax.config, "jax_platforms", "") or ""
    )
    if plats.split(",")[0].strip() == "cpu":
        return
    if jax.default_backend() == "cpu":
        return
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(DEFAULT_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
