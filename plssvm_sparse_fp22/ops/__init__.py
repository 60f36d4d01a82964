"""Compute ops: kernel functions, implicit Gram matvec, sparse packings.

JAX replacement for the reference's five per-backend device-kernel
families (``src/plssvm/backends/{OpenMP,CUDA,HIP,OpenCL,SYCL}``): the hot
implicit kernel-matrix x vector product is implemented once against XLA
(``matvec.py``, ``sparse.py``); every device kind is served by the same
traced program.
"""

from .kernel_functions import gram_block, gram_matrix, kernel_scalar
from .matvec import MatvecOperator, build_operator

__all__ = [
    "gram_block",
    "gram_matrix",
    "kernel_scalar",
    "MatvecOperator",
    "build_operator",
]
