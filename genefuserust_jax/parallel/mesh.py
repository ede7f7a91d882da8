"""Device-mesh construction for the multi-chip scan paths.

The reference's intra-process thread pipeline (rayon + crossbeam queue,
src/core/pescanner.rs:296-425) maps to data-parallel read batches over a
1-D mesh: the panel index is REPLICATED on every device (it is small
relative to device memory) and batches are SHARDED over the mesh axis. The PRODUCT
implementation lives in parallel/engine.py (DeviceEngine(mesh=...), jit
auto-SPMD) and parallel/sharded_engine.py (contig-sharded index for
whole-genome panels); this module holds the shared mesh constructor.

Multi-host deployment: the same programs under jax.distributed — batches
arrive host-local (process-local shards) and XLA lowers the collectives
(see parallel/distributed.py and tests/test_distributed.py).
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh


def make_mesh(devices=None, axis: str = "data") -> Mesh:
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))
