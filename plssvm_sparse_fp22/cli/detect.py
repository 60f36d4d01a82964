"""``plssvm-detect``: report available hardware and the selected defaults.

Analog of ``utility_scripts/plssvm_target_platforms.py`` (the
reference's hardware-detection helper that assembles the
``PLSSVM_TARGET_PLATFORMS`` CMake string): prints the JAX platform, device
list, and the backend/mode the framework would pick.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="plssvm-detect", description="detect available devices and defaults"
    )
    parser.add_argument("--json", action="store_true", help="machine-readable output")
    args = parser.parse_args(argv)

    import jax

    from ..types import BackendType

    platform = jax.default_backend()
    devices = [str(d) for d in jax.devices()]
    backend = BackendType.automatic

    info = {
        "platform": platform,
        "num_devices": len(devices),
        "devices": devices,
        "default_backend": str(backend),
        "x64": bool(jax.config.jax_enable_x64),
    }
    if args.json:
        print(json.dumps(info))
    else:
        print(f"platform:        {platform}")
        print(f"devices ({len(devices)}):")
        for d in devices:
            print(f"  {d}")
        print(f"default backend: {backend}")
        print(f"x64 enabled:     {info['x64']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
