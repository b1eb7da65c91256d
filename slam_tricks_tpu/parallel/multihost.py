"""Multi-host setup helpers (SURVEY §5 "Distributed communication backend"):
`jax.distributed.initialize` + a global mesh spanning hosts, so the
observation-sharded / landmark-local BA solvers scale across a pod slice —
per-iteration cross-host traffic is the psum'd pose-side blocks
(O(C^2*36) bytes with landmark-locality; rides DCN between slices, ICI
within).

The same code paths are validated without hardware by
tests/test_multihost.py, which launches N real processes with CPU devices and
a local coordinator.
"""

import jax
import numpy as np
from jax.sharding import Mesh


def initialize_multihost(coordinator_address=None, num_processes=None,
                         process_id=None):
    """Thin wrapper over jax.distributed.initialize. With no arguments JAX
    auto-detects a cluster environment (e.g. Slurm); a host with none needs
    all three arguments (coordinator_address as "host:port")."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def global_obs_mesh(axis_name="obs"):
    """1-D mesh over ALL devices of ALL processes (each process passes its
    local shards; jax assembles the global array)."""
    return Mesh(np.array(jax.devices()).reshape(-1), axis_names=(axis_name,))


def host_local_slice(n_total, axis_len=None):
    """(start, size) of this process's slice of a length-n_total sharded axis."""
    nproc = jax.process_count()
    pid = jax.process_index()
    assert n_total % nproc == 0, "pad the axis to a multiple of process_count"
    size = n_total // nproc
    return pid * size, size


def make_global_array(local_np, mesh, spec):
    """Build a globally-sharded jax.Array from this host's local shard."""
    from jax.sharding import NamedSharding

    sharding = NamedSharding(mesh, spec)
    global_shape = (local_np.shape[0] * jax.process_count(),) + local_np.shape[1:]
    return jax.make_array_from_process_local_data(sharding, local_np, global_shape)
