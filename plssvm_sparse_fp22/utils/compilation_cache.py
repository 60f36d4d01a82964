"""Persistent XLA compilation cache.

JAX equivalent of the reference's SHA-256-keyed on-disk OpenCL binary
cache (``src/plssvm/backends/OpenCL/detail/utility.cpp:233-355``): the
first compilation of a (shape, kernel, mode) learn program is expensive, so
compiled executables are kept on disk keyed by the program fingerprint and
every later process starts warm.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR``, when set: JAX reads it itself, and this
  module sets no directory of its own;
- otherwise :data:`CHECKOUT_CACHE_DIR`, one fixed directory inside the
  checkout (listed in ``.gitignore``).  The path is part of what a cache
  entry is found by, so it never depends on a temporary directory, a
  process or a time.

Enabled by the CLI and bench entry points; ``PLSSVM_NO_COMPILATION_CACHE=1``
opts out.  CPU executables are not cached: they are compiled for the
compiling host's instruction set.
"""

from __future__ import annotations

import os

#: the cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the checkout's."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_compilation_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; returns the directory,
    or None when disabled or on the CPU.  A backend that fails to start
    raises here, as anywhere else."""
    if os.environ.get("PLSSVM_NO_COMPILATION_CACHE") == "1":
        return None
    import jax

    if jax.default_backend() == "cpu":
        return None
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(CHECKOUT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    # cache every program regardless of its compile time / size
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir()
