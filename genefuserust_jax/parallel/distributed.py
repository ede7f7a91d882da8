"""Multi-host deployment helpers.

The reference is a single-process tool; its scale-out analog here
(SURVEY §5 "distributed communication backend") is:

  - DATA parallelism: read batches sharded over all devices
    (DeviceEngine(mesh=...), parallel/engine.py). Each host feeds its
    process-local shard from its own FASTQ partition; per-shard match
    records are host-gathered and merged — the deterministic
    (read_break desc, len asc, name desc) sort makes the merged result
    independent of shard boundaries.
  - INDEX sharding: whole-genome panels partitioned by contig over the
    'shard' mesh axis with replicated reads (parallel/sharded_index.py).
  - 2D: both axes combined — Mesh(devices.reshape(data, shard),
    ("data", "shard")); batches sharded on 'data', index on 'shard'.

Usage on several hosts (one process per host):

    from genefuserust_jax.parallel import distributed
    distributed.init()            # jax.distributed.initialize()
    mesh = distributed.make_mesh(data_axis=..., shard_axis=...)

XLA lowers the collectives under shard_map / jit auto-SPMD (NCCL on
GPUs). Validated by a REAL
two-process run in tests/test_distributed.py (coordinator + global mesh +
cross-process psum on the CPU backend).
"""

from __future__ import annotations

import logging
from typing import Optional

log = logging.getLogger("genefuse")


def init(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with env-var defaults; no-op when
    single-process."""
    import jax

    if num_processes in (None, 1) and coordinator_address is None:
        log.info("distributed init skipped (single process)")
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(),
        jax.process_count(),
        jax.local_device_count(),
        jax.device_count(),
    )


def make_mesh(data_axis: int = 0, shard_axis: int = 1):
    """2D mesh over all global devices: ('data', 'shard'). data_axis=0
    means use all devices for data parallelism (shard dim 1)."""
    import numpy as np

    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices())
    n = len(devs)
    if data_axis <= 0 and shard_axis <= 0:
        data_axis, shard_axis = n, 1
    elif data_axis <= 0:
        data_axis = n // shard_axis
    elif shard_axis <= 0:
        shard_axis = n // data_axis
    assert data_axis * shard_axis == n, (data_axis, shard_axis, n)
    return Mesh(devs.reshape(data_axis, shard_axis), ("data", "shard"))
