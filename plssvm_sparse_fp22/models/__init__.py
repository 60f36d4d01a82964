"""Model layer: the LS-SVM estimator and its factory.

JAX equivalent of ``plssvm::csvm<T>`` (``include/plssvm/csvm.hpp``),
``plssvm::detail::gpu_csvm`` (``include/plssvm/backends/gpu_csvm.hpp``) and
``plssvm::make_csvm`` (``include/plssvm/csvm_factory.hpp``).  The backend
class hierarchy collapses: XLA serves every device, so there is a single
:class:`CSVM` whose matvec strategy is picked per (kernel, size, memory).
"""

from .base import CSVM
from .factory import make_csvm

__all__ = ["CSVM", "make_csvm"]
