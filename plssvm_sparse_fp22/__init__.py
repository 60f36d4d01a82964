"""PLSSVM in JAX: a Least-Squares Support Vector Machine framework.

A JAX/XLA implementation with the capabilities of
PLSSVM v1.2.0 (reference: bohein/PLSSVM_Sparse_FP22): binary C-SVC trained by
solving the LS-SVM linear system with Conjugate Gradients, linear /
polynomial / RBF kernels, LIBSVM (dense + sparse) and ARFF data files,
LIBSVM-compatible model checkpoints, ``plssvm-train`` / ``plssvm-predict``
CLIs and a library API — plus a native sparse (CSR) kernel-matvec path and
multi-chip row sharding with XLA collectives, which the reference lacks.

Public surface mirrors ``include/plssvm/core.hpp:14-95``.
"""

from .exceptions import (
    BackendError,
    FileNotFoundError_,
    InvalidFileFormatError,
    InvalidParameterError,
    PLSSVMError,
    UnsupportedBackendError,
    UnsupportedKernelTypeError,
)
from .models import CSVM, make_csvm
from .params import Parameter
from .types import (
    BackendType,
    KernelType,
    TargetPlatform,
    list_available_backends,
    list_available_target_platforms,
)
from .version import VERSION as __version__

__all__ = [
    "CSVM",
    "make_csvm",
    "Parameter",
    "KernelType",
    "BackendType",
    "TargetPlatform",
    "list_available_backends",
    "list_available_target_platforms",
    "PLSSVMError",
    "InvalidParameterError",
    "FileNotFoundError_",
    "InvalidFileFormatError",
    "UnsupportedBackendError",
    "UnsupportedKernelTypeError",
    "BackendError",
    "__version__",
]
