"""Estimator factory.

JAX equivalent of ``plssvm::make_csvm``
(``include/plssvm/csvm_factory.hpp:53-111``).  The reference dispatches over
five compiled-in backends; here every backend name resolves onto the single
XLA compute path, so the factory validates the request and constructs
:class:`~plssvm_sparse_fp22.models.base.CSVM`.
"""

from __future__ import annotations

from ..params import Parameter
from ..types import BackendType, list_available_backends
from ..exceptions import UnsupportedBackendError
from .base import CSVM


def make_csvm(params: Parameter) -> CSVM:
    if not isinstance(params.backend, BackendType):
        params.backend = BackendType.from_string(str(params.backend))
    if params.backend not in list_available_backends():
        raise UnsupportedBackendError(f"Unrecognized backend type '{params.backend}'!")
    return CSVM(params)
