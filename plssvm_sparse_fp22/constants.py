"""Compile-time tuning constants.

Analog of ``include/plssvm/constants.hpp:16-43``.  The reference exposes
CUDA-convention tiling knobs (``THREAD_BLOCK_SIZE=16``,
``INTERNAL_BLOCK_SIZE=6``, ``OPENMP_BLOCK_SIZE=64``).  Here XLA tiles its
own GEMMs, so what remains are the row block of the blocked XLA implicit
matvec and the padding of the CG system.  The knobs are overridable via
environment variables (the analog of the reference's CMake macro
overrides, ``CMakeLists.txt:398-438``).
"""

from __future__ import annotations

import os


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


#: rows per block of the blocked XLA implicit matvec (``ops/matvec.py``):
#: each step forms one (ROW_BLOCK_SIZE, D) Gram block.
ROW_BLOCK_SIZE: int = _env_int("PLSSVM_ROW_BLOCK_SIZE", 256)

#: padding applied to the CG system size so every block is full.
#: Analog of ``boundary_size_ = THREAD_BLOCK_SIZE * INTERNAL_BLOCK_SIZE``
#: (``gpu_csvm.cpp:133``).
PAD_SIZE: int = _env_int("PLSSVM_PAD_SIZE", 128)

#: CG residual recompute interval (``gpu_csvm.cpp:272``, ``OpenMP/csvm.cpp:130``).
RESIDUAL_REFRESH_INTERVAL: int = 50

assert ROW_BLOCK_SIZE % 8 == 0, "ROW_BLOCK_SIZE must be a multiple of 8"
assert PAD_SIZE % 8 == 0, "PAD_SIZE must be a multiple of 8"
