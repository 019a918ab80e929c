"""The accelerator a measurement runs on.

Every device number this repository prints names the device it came
from: JAX's platform, ``device_kind`` and device count, and the card's
name and power limit as ``nvidia-smi`` reports them (a card set below
its maximum power runs slower under load). A measurement path that finds
no GPU fails; it never falls back to the CPU.
"""

from __future__ import annotations

import subprocess
import time
from typing import Dict

__all__ = [
    "NoGPUError",
    "require_gpu",
    "device_record",
    "nvidia_smi_name_power",
    "copy_gbs",
]


class NoGPUError(RuntimeError):
    """JAX found no GPU."""


def require_gpu():
    """The first JAX device; raises :class:`NoGPUError` unless a GPU."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        raise NoGPUError(
            f"JAX found no GPU (first device: {device.platform}, "
            f"{device.device_kind}); this measurement runs only on the card"
        )
    return device


def device_record() -> Dict[str, object]:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi_name_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one card a line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def copy_gbs(nbytes: int = 1 << 30, repeats: int = 10) -> float:
    """Device-to-device copy rate of an ``nbytes`` buffer, in GB/s.

    Counts the bytes read plus the bytes written (``2 * nbytes``), the
    traffic a memory-bound kernel is compared with. Median of ``repeats``
    warmed, ``block_until_ready``-bracketed copies.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    src = jnp.zeros((nbytes // 4,), jnp.float32)
    copy = jax.jit(lambda a: a + 1.0)
    copy(src).block_until_ready()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        copy(src).block_until_ready()
        times.append(time.perf_counter() - t0)
    return 2 * nbytes / float(np.median(times)) / 1e9
