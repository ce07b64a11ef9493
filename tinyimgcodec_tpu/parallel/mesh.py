"""Device mesh construction and multi-host initialization."""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all).

    Codec workloads shard along a single axis -- images (data parallel)
    or block-tiles of one large image (spatial parallel).  The GPUs of
    one host are joined all to all by NVLink, so device order along the
    axis does not matter.
    """
    devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, have {len(devices)}"
            )
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis,))


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Multi-host bring-up (no-op on single host).

    Thin wrapper over ``jax.distributed.initialize``.  Pass all three
    arguments (``coordinator`` as ``host:port``): nothing autodetects a
    cluster on a plain GPU or CPU host.
    """
    if num_processes is not None and num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
