"""Which accelerator a run is on, for scripts that measure it.

A measurement names the device it ran on and refuses to fall back to the
CPU: a CPU number is never reported under a device metric's name.
"""

from __future__ import annotations

import subprocess
from typing import Dict


class NoGpuError(RuntimeError):
    """JAX found no GPU."""


def require_gpu() -> Dict[str, object]:
    """The default device as JAX reports it; raises NoGpuError unless it
    is a GPU."""
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        raise NoGpuError(
            f"no GPU found: JAX's default device is {dev.platform!r} "
            f"({dev.device_kind}); this measurement runs only on a GPU")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def nvidia_smi() -> Dict[str, str]:
    """Name and power limit of the first card, from nvidia-smi in a child
    process (which stays off JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    name, power = (f.strip() for f in out.splitlines()[0].split(",", 1))
    return {"name": name, "power_limit": power}
