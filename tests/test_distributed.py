"""Multi-process jax.distributed init path (parallel/distributed.py).

Spawns two REAL processes on localhost (CPU backend, 4 virtual devices
each), initializes the distributed runtime through distributed.init, forms
the 8-device global mesh with distributed.make_mesh, and runs a psum over
the 'data' axis — validating that the helpers produce a working multi-host
collective setup (DCN analog), not just plausible code."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import sys
import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")

coord, pid = sys.argv[1], int(sys.argv[2])

from genefuserust_jax.parallel import distributed

distributed.init(coordinator_address=coord, num_processes=2, process_id=pid)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 8, jax.device_count()

mesh = distributed.make_mesh(data_axis=8, shard_axis=1)
assert mesh.axis_names == ("data", "shard")

from functools import partial

from jax.sharding import NamedSharding, PartitionSpec as P

@partial(jax.shard_map, mesh=mesh, in_specs=P("data"), out_specs=P())
def total(x):
    return jax.lax.psum(x.sum(), "data")[None]

# each process contributes its local half of a global length-8 array
local = np.arange(4, dtype=np.int32) + 100 * (pid + 1)
garr = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P(("data", "shard"))), local, (8,)
)
out = total(garr)
expected = (100 * 1 + 100 * 2) * 4 + 2 * (0 + 1 + 2 + 3)
assert int(np.asarray(out)[0]) == expected, np.asarray(out)
print(f"proc {pid} OK", flush=True)
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_init(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, coord, str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            env=env,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert f"proc {i} OK" in out
