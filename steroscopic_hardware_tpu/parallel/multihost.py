"""Multi-host runtime bring-up.

The reference's "multi-host" story is two Zedboards on UART plus a single
Go process; the equivalent here is a ``jax.distributed`` cluster of GPU
hosts:

* each host runs the same program and calls :func:`init_distributed`;
* frame ingest is per-host (each host owns its camera TCP endpoints and
  publishes into its local bus — the sharded equivalent of the two-board
  topology);
* the global mesh spans all hosts' devices; sharded computations
  (``parallel/disparity_shard.py``, ``parallel/ba_dist.py``) use NVLink
  collectives among a host's cards and the network between hosts,
  following the mesh's device order.

Single-process (one-host) initialization is a no-op-safe path so the same
entry point works everywhere.
"""

from __future__ import annotations

import os

import jax

from steroscopic_hardware_tpu.runtime.logger import get_logger


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> dict:
    """Initialize the multi-host runtime.

    With no arguments, reads the standard env vars
    (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``) and falls back to single-process mode when they
    are absent. Returns a summary dict.
    """
    log = get_logger("multihost")
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))

    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        log.info(
            "distributed runtime up: process %d/%d, coordinator %s",
            process_id, num_processes, coordinator_address,
        )
    else:
        log.info("single-process runtime (no coordinator configured)")

    info = {
        "process_id": process_id,
        "num_processes": num_processes,
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
    return info


def global_mesh(axis_names=("batch", "rows")):
    """Build a mesh over ALL processes' devices, batch-major so that the
    ``rows`` (spatial) axis stays within a host's local devices when
    possible (halo ppermute rides NVLink, not the network)."""
    from steroscopic_hardware_tpu.parallel.mesh import make_mesh

    n_local = len(jax.local_devices())
    n_total = len(jax.devices())
    n_batch = max(1, n_total // n_local)
    return make_mesh(n_rows=n_local, n_batch=n_batch)
