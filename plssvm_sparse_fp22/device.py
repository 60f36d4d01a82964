"""What the device JAX runs on offers, resolved in one place.

The learn paths ask here whether a requested target platform is present
and how much memory a device has.
"""

from __future__ import annotations

import os

import jax

from .exceptions import PLSSVMError, UnsupportedBackendError
from .types import TargetPlatform


def check_target(target: TargetPlatform) -> None:
    """Raise unless the requested target platform is the one JAX runs on
    (``automatic`` takes whatever is there)."""
    if target == TargetPlatform.automatic:
        return
    dev = jax.devices()[0]
    present = (dev.platform == "cpu" if target == TargetPlatform.cpu
               else dev.platform == "gpu" and "NVIDIA" in dev.device_kind)
    if not present:
        raise UnsupportedBackendError(
            f"target platform '{target}' requested, but JAX runs on "
            f"'{dev.platform}' ({dev.device_kind})")


def device_memory_bytes() -> int:
    """Memory of one device: the limit the runtime reports for a GPU
    (``memory_stats()["bytes_limit"]``, the part JAX reserved), the host's
    physical memory for the CPU.  A device that reports neither is an
    error: every memory guard would otherwise pass blindly."""
    dev = jax.devices()[0]
    stats = dev.memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    if limit > 0:
        return limit
    if dev.platform == "cpu":
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    raise PLSSVMError(
        f"device {dev.device_kind} ({dev.platform}) reports no memory limit")
