"""Multi-host distributed setup: tensor parallelism within a host,
data parallelism across hosts.

The reference delegates all multi-device work to HF accelerate device maps
(SURVEY.md section 2.3); here multi-host inference uses
``jax.distributed.initialize`` plus a mesh whose inner (tensor-parallel)
axis holds the cards of one host, joined by NVLink, and whose outer
(data-parallel) axis spans hosts -- the per-layer collectives stay on
NVLink and only batch-parallel traffic crosses the network between hosts.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None):
    """Initialize multi-host JAX. No-op on a single process (all args
    None and no cluster env detected)."""
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception:
            return False  # single-process
        return True
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_multihost_mesh(tp: Optional[int] = None) -> Mesh:
    """dp x tp mesh with tp contiguous within each host (NVLink) and dp
    spanning hosts."""
    devices = jax.devices()
    local = jax.local_device_count()
    tp = tp or local
    assert len(devices) % tp == 0, \
        f"{len(devices)} devices not divisible by tp={tp}"
    dp = len(devices) // tp
    # jax.devices() orders by process; reshaping keeps tp within a process
    # (host) so tensor-parallel collectives stay on NVLink
    arr = np.asarray(devices).reshape(dp, tp)
    return Mesh(arr, ("dp", "tp"))


def is_primary() -> bool:
    return jax.process_index() == 0
