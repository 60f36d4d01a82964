"""Enumerations with string round-trips.

JAX equivalents of the reference enums:

- :class:`KernelType`      — ``include/plssvm/kernel_types.hpp:27-34`` and the
  stream operators in ``src/plssvm/kernel_types.cpp`` (names or integer
  strings, case-insensitive).
- :class:`BackendType`     — ``include/plssvm/backend_types.hpp`` /
  ``src/plssvm/backend_types.cpp:26-115``.  The reference's five compute
  backends (OpenMP/CUDA/HIP/OpenCL/SYCL) collapse onto XLA: every device kind
  is served by the same traced program.  ``automatic`` names it; ``xla`` and
  the reference's historical names are aliases for it so CLI invocations
  remain compatible.
- :class:`TargetPlatform`  — ``include/plssvm/target_platforms.hpp`` /
  ``src/plssvm/target_platforms.cpp:21-73``: ``automatic/cpu/gpu_nvidia``;
  ``device.check_target`` refuses a platform that is not present.
"""

from __future__ import annotations

import enum

from .exceptions import UnsupportedBackendError, UnsupportedKernelTypeError


class KernelType(enum.IntEnum):
    """Kernel functions (``kernel_types.hpp:27-34``)."""

    linear = 0
    polynomial = 1
    rbf = 2

    def __str__(self) -> str:  # mirrors operator<< (kernel_types.cpp)
        return self.name

    @classmethod
    def from_string(cls, s: str) -> "KernelType":
        """Parse from a name or integer string, case-insensitively.

        Mirrors ``operator>>(std::istream&, kernel_type&)``
        (``kernel_types.cpp``).
        """
        t = str(s).strip().lower()
        if t in ("linear", "0"):
            return cls.linear
        if t in ("polynomial", "1"):
            return cls.polynomial
        if t in ("rbf", "2"):
            return cls.rbf
        raise UnsupportedKernelTypeError(f"Unrecognized kernel type '{s}'!")


class BackendType(enum.Enum):
    """Compute-path selection (``backend_types.hpp``): one member, the XLA
    program, which runs on any JAX platform (the analog of
    ``determine_default_backend``, ``backend_types.cpp:51-74``, has one
    candidate)."""

    automatic = "automatic"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(cls, s: str) -> "BackendType":
        t = str(s).strip().lower()
        # reference backend names map onto the single XLA compute path;
        # accepted for CLI compatibility (backend_types.cpp:76-115)
        aliases = {
            "xla": cls.automatic,
            "openmp": cls.automatic,
            "cuda": cls.automatic,
            "hip": cls.automatic,
            "opencl": cls.automatic,
            "sycl": cls.automatic,
        }
        if t in aliases:
            return aliases[t]
        if t == "pallas":
            raise UnsupportedBackendError(
                "Backend 'pallas' was removed: XLA's implicit matvec was faster "
                "on the H100 (docs/PERF.md); use 'automatic'!")
        for member in cls:
            if member.value == t:
                return member
        raise UnsupportedBackendError(f"Unrecognized backend type '{s}'!")


def list_available_backends() -> list[BackendType]:
    """All compute paths available in this build

    (analog of ``list_available_backends``, ``backend_types.cpp:26-44``)."""
    return list(BackendType)


class TargetPlatform(enum.Enum):
    """Hardware target (``target_platforms.hpp``): the reference's own names
    for the platforms this build runs on.  ``gpu_amd`` and ``gpu_intel``
    parse to a clear error: JAX here has no route to them."""

    automatic = "automatic"
    cpu = "cpu"
    gpu_nvidia = "gpu_nvidia"

    def __str__(self) -> str:
        return self.value

    @classmethod
    def from_string(cls, s: str) -> "TargetPlatform":
        t = str(s).strip().lower()
        for member in cls:
            if member.value == t:
                return member
        if t in ("gpu_amd", "gpu_intel"):
            raise UnsupportedBackendError(
                f"Target platform '{s}' is not supported by this build!")
        raise UnsupportedBackendError(f"Unrecognized target platform '{s}'!")


def list_available_target_platforms() -> list[TargetPlatform]:
    """Analog of ``list_available_target_platforms`` (``target_platforms.cpp``)."""
    return list(TargetPlatform)
