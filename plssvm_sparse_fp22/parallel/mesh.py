"""Device-mesh construction helpers.

JAX replacement for the reference's device enumeration
(``CUDA/csvm.cu:52-63``: ``devices_ = min(device_count, num_features)`` and
the poly/rbf single-GPU restriction).  Here *every* kernel type scales to
every chip: the row axis is sharded, so there is no feature-count cap and no
single-device fallback.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


DATA_AXIS = "data"


def make_mesh(num_devices: int | None = None, devices=None) -> Mesh:
    """Build the 1-D data mesh over the first ``num_devices`` devices."""
    if devices is None:
        devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))
