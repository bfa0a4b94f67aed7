"""Multi-host initialization + global-array helpers.

The reference has no distributed backend at all (SURVEY.md §2.3); here
multi-host runs use JAX's native runtime: `jax.distributed.initialize` over
the network, then a global mesh whose data axis spans every GPU of every
host. XLA hands the collectives to NCCL — NVLink within a host, the network
across hosts — with no hand-written transport.

Typical usage (every host runs the same program):

    from moptimizer_jax.parallel import multihost
    multihost.initialize(coordinator_address=..., num_processes=N,
                         process_id=i)         # or no args under a cluster manager
    mesh = multihost.global_mesh()             # ("data",) over all chips
    blk  = multihost.make_global_block(local_block, mesh)   # local rows in
    res  = distributed_levenberg_marquardt(problem(blk), x0, mesh, cfg)

Each host feeds only its local shard of the residual data; every reduction
in the engine (psum of H,b, segment-sums in BA) becomes a cross-host
collective automatically under GSPMD. Exercised end-to-end by
tests/test_multihost.py (2 CPU processes over a local gloo coordinator).
"""

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec


def is_initialized():
    """True iff jax.distributed has a live coordinator client."""
    from jax._src import distributed

    return distributed.global_state.client is not None


def initialize(**kwargs):
    """Idempotent `jax.distributed.initialize`.

    * already initialized → no-op;
    * explicit arguments (coordinator_address/num_processes/process_id) →
      initialize, and FAILURES PROPAGATE — a broken DCN init must never be
      silently ignored;
    * no arguments → rely on the cluster auto-detection that
      jax.distributed.initialize does (Slurm, Open MPI, Kubernetes); if no cluster environment is detectable this is a
      single-process run and we proceed unchanged.
    """
    if is_initialized():
        return
    if kwargs:
        jax.distributed.initialize(**kwargs)
        return
    try:
        jax.distributed.initialize()
    except (RuntimeError, ValueError):
        # no auto-detectable cluster → single-process run; any OTHER error
        # (a real failed handshake once args are given) propagates above
        pass


def global_mesh(axis="data"):
    """1-D mesh over every chip across all hosts (local chips first on each
    host is NOT guaranteed — use jax.devices() ordering everywhere)."""
    return Mesh(np.array(jax.devices()), (axis,))


def host_local_shard(array, axis=0):
    """This host's contiguous shard of a replicated host array (split by
    process index; the last process absorbs the remainder)."""
    n = jax.process_count()
    i = jax.process_index()
    size = array.shape[axis]
    chunk = size // n
    start = i * chunk
    stop = size if i == n - 1 else start + chunk
    index = [slice(None)] * array.ndim
    index[axis] = slice(start, stop)
    return array[tuple(index)]


def make_global_array(local_rows, mesh, axis="data"):
    """Assemble per-process row shards into one global jax.Array sharded
    along `axis`. Every process passes its OWN rows; the global leading dim
    is the sum over processes. Local row counts must divide evenly onto the
    local devices of the mesh axis."""
    sharding = NamedSharding(mesh, PartitionSpec(axis))
    return jax.make_array_from_process_local_data(sharding, np.asarray(local_rows))


def make_global_block(block, mesh, axis="data"):
    """ResidualBlock whose data each process supplies as its local rows →
    block over the global (distributed) residual set.

    The returned block plugs directly into
    parallel.sharded.distributed_levenberg_marquardt: its data leaves are
    already global arrays with the target sharding, so the GSPMD path's
    device_put is a no-op and XLA inserts cross-device collectives for the
    Gauss-Newton reductions."""
    if block.data is None:
        return block
    data = jax.tree_util.tree_map(
        lambda leaf: make_global_array(leaf, mesh, axis), block.data
    )
    return dataclasses.replace(block, data=data)
