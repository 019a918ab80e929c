"""Device mesh construction + multi-host process-group initialization.

On a GPU host one process drives every card of the host, and a 1-D
``Mesh`` over all addressable devices carries the data-parallel axis;
XLA hands its collectives to NCCL (NVLink within a host). Several hosts
form one process group through ``jax.distributed.initialize()``, one
process per host, with the coordinator address, process count and
process id given explicitly.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh

__all__ = ["make_mesh", "distributed_init", "device_count"]

DP_AXIS = "dp"


_DIST_INITIALIZED = False


def distributed_init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize the multi-host process group; returns True on success.

    Must run before anything touches the XLA backend (so no
    ``jax.devices()``/``jax.process_count()`` guards here — they would
    themselves initialize the backend and make ``initialize()`` raise).
    Pass ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id``: a GPU cluster publishes no metadata for
    ``jax.distributed.initialize`` to find them itself. Without them,
    or with the backend already up, the call fails and the process
    stays single-process (one process driving all local cards).
    """
    global _DIST_INITIALIZED
    if _DIST_INITIALIZED:
        return True
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _DIST_INITIALIZED = True
        return True
    except (RuntimeError, ValueError):
        # No coordinator given / backend already up: single-process
        # operation over the local devices.
        return False


def device_count() -> int:
    return len(jax.devices())


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    axis_name: str = DP_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """A 1-D mesh over ``n_devices`` devices (default: all addressable)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(
                    f"requested {n_devices} devices, only {len(devices)} present"
                )
            devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))
